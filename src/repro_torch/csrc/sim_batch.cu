// The batch simulator's run loop as one kernel: every tick of every lane of
// a chunk, to completion, in one launch.
//
// Replaces no TPU kernel.  It is the counterpart of the reference's single
// compiled `lax.while_loop` (src/repro/sim/batch.py:629-1102, `_run_jax`),
// which the PyTorch port otherwise runs as ~700-1,800 small kernels a tick,
// driven from the host in blocks (`repro_torch.sim.batch._tick_fn`, its
// plain version, which stays the CPU path and the yardstick on the card).
//
// Design.  One lane (one independent simulation) is one CTA of one warp.
// The CTA copies its lane's mutable planes into dynamic shared memory (its
// "image"), ticks it there to completion and writes it back once.  The
// image holds the warp rows `wf`, readiness rows `cf`, register times `rv`
// (each row's float64 time apart from its memory flag, a byte), the active
// list, residency, prefetch slots, collectors, the RFC table's keys and
// stamps apart, and the breakdown.  The host sizes the image from the
// chunk's widths and names its route (kernels/sim_batch/ops.py, which
// mirrors `image_of`): `shared` also images `rv` and the read-only tables
// (`meta`, `ivt`, `ivregs`); `global`, for widths whose image would not fit
// a CTA's shared memory, leaves them in their global planes.  A width that
// fits neither is refused (the launch raises).
// Blocks take lanes from the last: a chunk's lanes are sorted by their
// length estimate, shortest first (`_chunk_lanes`), so the longest start
// first when the chunk runs in waves.
//
// Every lane scalar (cycle, counters, the token bucket, the DRAM queue) is
// held by every thread, and the reference's serial steps run on all 32
// threads at once with the same values, so no thread waits for another's
// broadcast.  Short serial steps (a readiness row's sources, an
// instruction's destinations, an interval's registers) stay serial with
// their loads issued together: spreading them over the warp and reducing
// measured slower on the card.  Loops over the simulated warps (W <= 64),
// the active list (A <= 64), the collectors, the prefetch slots and the
// operands are spread over the warp: ballots for the first-index picks and
// prefix counts, `redux.sync` reductions for the rest (a non-negative int64
// reduced on its value saturated to 32 bits, both words only when every
// value saturates), the first index on ties.  Across the issue slots of a
// tick each thread keeps its active positions' status, end flag and
// readiness in registers and reloads only the issued warp's; a slot that
// issues nothing ends the tick's slots.  The RFC table's keys sit in the
// image with an index from each key to its entry, so a lookup is one load
// an operand; the stamps of its first 128 entries sit in registers, 4 a
// thread, so the LRU victim is one warp argmin.  What the reference orders
// stays in order: the activation in wid order, the issue slots one after
// another, the token bucket, the RFC's LRU hits and inserts in operand
// order.  The activation is exact: no bound, no snapshot, no rerun.
// Threads that run a serial step alike write the same value to an image
// word, each after a sync() that follows every thread's earlier reads of
// it, so a thread that runs ahead never changes a word another has yet to
// read; a read-modify-write that no other thread reads before the next
// sync() is thread 0's alone.  Each
// lane ticks while it is alive and its own tick count is <= tmax; the
// chunk's `guard` is the largest count over its lanes, which is the
// reference's chunk-wide count.
//
// What bounds it: a tick is a short dependent chain of small integer and
// float64 steps on one lane's image, so a lane's time is latency (shared
// memory round trips, warp reductions) and instruction issue, not bytes or
// operations; the chunk's time is its longest lane's.  No roofline applies.
//
// Traps, each kept below:
// * float64: every site performs the reference's operations in its order.
//   This source is compiled with -fmad=false (kernels/_build.py), so no
//   product contracts into an FMA with the add that consumes it; `/` is the
//   IEEE quotient (the divisions by 65535 and 8191 included); a float to
//   int64 cast truncates toward zero, as torch's `.to(int64)` does.  The
//   next event's cycle is the truncation of the earliest time, taken as the
//   smallest truncation (times are >= 0 and below 2^53).
// * int64 hashes are computed in uint64 (signed overflow is undefined in
//   C++ and wraps in PyTorch) and only their low bits are used.
// * `%` is Python's (torch.remainder): on the non-negative cycle, `mod_small`.
// * argmin/argmax take the first index on ties; _BIG = 2^60 is "never".
//   Writes that the plain version sends to a trash row simply do not happen.
// * `rv`'s memory flag is 0.0 or 1.0 in the plane (`_build` starts it at
//   0.0, and the tick writes only those): the image keeps it as a byte.
//
// Built for the host too (a C++ compiler without CUDA: one thread a lane,
// the same code, the image in a host buffer), so that its logic can be held
// to the plain tick on a CPU.
#include <climits>
#include <cmath>
#include <cstdint>
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define SB_DEV __device__ __forceinline__
#define SB_HD __host__ __device__ inline
#define SB_T 32
#else
#include <algorithm>
#include <vector>
#define SB_DEV inline
#define SB_HD inline
#define SB_T 1
#endif

namespace {

// The planes of the chunk, in the order of `PLANES` in
// repro_torch/kernels/sim_batch/ops.py (checked at load through `layout`).
#define SB_PLANES(X)                                                                    \
  X(meta) X(ivt) X(ivregs) X(endpc) X(mrfc) X(rfcc) X(brf_f) X(wlat) X(rate) X(l1h)      \
  X(xbar) X(banksf) X(aluf) X(memf) X(drint) X(brf_i) X(l1c) X(thr) X(seed) X(maxc)     \
  X(tmax) X(iw) X(nw) X(rcap) X(acap) X(tcap) X(ecap) X(cached) X(edge) X(bl) X(rfc)    \
  X(ideal) X(fam) X(cycle) X(guard) X(alive) X(budget) X(wf) X(cf) X(rv) X(act) X(na)   \
  X(res) X(nr) X(ptr) X(pf) X(col) X(tok) X(mlast) X(dnext) X(rc) X(rcnt) X(rstamp)     \
  X(bd) X(ch) X(ca) X(cm) X(cpo) X(cpc) X(cps) X(cwb) X(cact)
#define SB_ENUM(n) PL_##n,
enum Plane { SB_PLANES(SB_ENUM) NPLANES };
#undef SB_ENUM

// `_dims` (repro_torch/sim/batch.py) then the widths it leaves implicit.
#define SB_DIMS(X)                                                                      \
  X(K) X(W) X(NWF) X(A) X(E) X(P) X(S) X(PS) X(DD) X(G) X(R) X(PRS) X(RVW) X(LS) X(DS)   \
  X(IVS) X(IW) X(PF) X(C) X(NCAT) X(GV) X(MW) X(CW) X(RV1)
#define SB_ENUM(n) D_##n,
enum Dim { SB_DIMS(SB_ENUM) NDIMS };
#undef SB_ENUM

#define SB_NAME(n) #n ","
const char kLayout[] =
    "planes=" SB_PLANES(SB_NAME) ";dims=" SB_DIMS(SB_NAME)
    ";status=ACTIVE,READY,WAIT,PREFETCH,DONE;ops=OTHER,BRA,EXIT,SET,LD"
    ";wf=ST,PC,IV,RA,IS,MO,LC;meta=KIND,NACC,PDST,TGT,TRIPS,LSL,DSL,IVPC"
    ";cats=issue,alu_dep,mem_stall,prefetch_stall,bank_conflict,scheduler_idle,drain";
#undef SB_NAME

// The image's routes, in `ROUTES` order (kernels/sim_batch/ops.py).
enum Route { R_SHARED, R_GLOBAL, NROUTES };

struct Args {
  void* planes[NPLANES];
  long long lane_stride[NPLANES];   // elements between two lanes' rows (0: one scalar)
  int dims[NDIMS];
  int route;                        // a Route
  long long image_bytes;            // image_of(dims, route).bytes
};

enum { ACTIVE, READY, WAIT, PREFETCH, DONE };
enum { OP_OTHER, OP_BRA, OP_EXIT, OP_SET, OP_LD };
enum { F_ST, F_PC, F_IV, F_RA, F_IS, F_MO, F_LC };
enum { M_KIND, M_NACC, M_PDST, M_TGT, M_TRIPS, M_LSL, M_DSL, M_IVPC, M_S };
enum { CAT_ISSUE, CAT_ALU_DEP, CAT_MEM, CAT_PREFETCH, CAT_BANK, CAT_IDLE, CAT_DRAIN, NCAT };

constexpr uint32_t NO_RANK = 0xffffffffu;   // a position off the active list
constexpr int MAX_W = 64;       // simulated warps a lane, and active-list width
constexpr int MAX_G = 16;       // operand registers an instruction
constexpr int PER_T = MAX_W / SB_T;
constexpr int RC_REG = 128;     // RFC entries held in registers (the rest in the image)
constexpr int RC_PER_T = RC_REG / SB_T;

// ------------------------------------------------------------------ the team
// The threads that run one lane: a warp on the card, one thread on the host.
#if defined(__CUDACC__)
constexpr unsigned FULL = 0xffffffffu;
SB_DEV int tid() { return threadIdx.x & 31; }   // (< 32 known: one-round loops fold)
SB_DEV void sync() { __syncwarp(); }
SB_DEV uint32_t ballot(bool p) { return __ballot_sync(FULL, p); }
SB_DEV uint32_t team_min_u32(uint32_t x) { return __reduce_min_sync(FULL, x); }
SB_DEV uint32_t team_sum_u32(uint32_t x) { return __reduce_add_sync(FULL, x); }
SB_DEV uint32_t team_or_u32(uint32_t x) { return __reduce_or_sync(FULL, x); }
SB_DEV int popc(uint64_t m) { return __popcll(m); }
SB_DEV int ctz(uint64_t m) { return __ffsll(static_cast<long long>(m)) - 1; }
#else
inline int tid() { return 0; }
inline void sync() {}
inline uint32_t ballot(bool p) { return p ? 1u : 0u; }
inline uint32_t team_min_u32(uint32_t x) { return x; }
inline uint32_t team_sum_u32(uint32_t x) { return x; }
inline uint32_t team_or_u32(uint32_t x) { return x; }
inline int popc(uint64_t m) { return __builtin_popcountll(m); }
inline int ctz(uint64_t m) { return __builtin_ctzll(m); }
#endif

template <class X> SB_DEV X mn(X a, X b) { return b < a ? b : a; }
template <class X> SB_DEV X mx(X a, X b) { return b > a ? b : a; }
// the min / max of 8 values as a tree of depth 3 (the same value as a chain)
template <class X> SB_DEV X min8(const X* v) {
  return mn(mn(mn(v[0], v[1]), mn(v[2], v[3])), mn(mn(v[4], v[5]), mn(v[6], v[7])));
}
template <class X> SB_DEV X max8(const X* v) {
  return mx(mx(mx(v[0], v[1]), mx(v[2], v[3])), mx(mx(v[4], v[5]), mx(v[6], v[7])));
}

// the smallest of the team's unsigned 64-bit values: the high words first,
// then the low words of the threads holding the high word
SB_DEV uint64_t team_min_u64(uint64_t x) {
  const uint32_t hi = team_min_u32(static_cast<uint32_t>(x >> 32));
  const uint32_t lo = team_min_u32(static_cast<uint32_t>(x >> 32) == hi
                                       ? static_cast<uint32_t>(x) : 0xffffffffu);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// x saturated to 32 bits: exact below 2^32 - 1
SB_DEV uint32_t sat32(uint64_t x) {
  return x < 0xffffffffull ? static_cast<uint32_t>(x) : 0xffffffffu;
}

// the smallest of the team's non-negative int64 values: one 32-bit
// reduction of the saturated values, both words only when every value
// saturates
SB_DEV int64_t team_min(int64_t x) {
  const uint32_t m = team_min_u32(sat32(static_cast<uint64_t>(x)));
  if (m != 0xffffffffu) return m;
  return static_cast<int64_t>(team_min_u64(static_cast<uint64_t>(x)));
}

// the smallest value over the team's (value, index) pairs and the smallest
// index holding it; values >= 0, each thread's pair its own first smallest
SB_DEV void team_argmin(int64_t& v, int& i) {
  const uint64_t u = static_cast<uint64_t>(v);
  const uint32_t s = sat32(u);
  const uint32_t m = team_min_u32(s);
  if (m != 0xffffffffu) {
    i = static_cast<int>(team_min_u32(s == m ? static_cast<uint32_t>(i) : 0xffffffffu));
    v = m;
    return;
  }
  const uint64_t m64 = team_min_u64(u);
  i = static_cast<int>(team_min_u32(u == m64 ? static_cast<uint32_t>(i) : 0xffffffffu));
  v = static_cast<int64_t>(m64);
}

// One value per operand of an instruction (G <= MAX_G <= 32): operand q's
// is thread q's on the card, and the host holds them all.  SB_OPERANDS(q)
// visits the operands the calling thread holds.
#if defined(__CUDACC__)
constexpr int OPN = SB_T;
template <class X> struct Spread {
  X v;
  SB_DEV X get(int q) const { return __shfl_sync(FULL, v, q); }
  SB_DEV X& at(int) { return v; }
  SB_DEV const X& at(int) const { return v; }
  SB_DEV uint32_t nonneg() const { return ballot(v >= 0); }   // the operands holding >= 0
};
#else
constexpr int OPN = MAX_G;
template <class X> struct Spread {
  X v[MAX_G];
  X get(int q) const { return v[q]; }
  X& at(int q) { return v[q]; }
  const X& at(int q) const { return v[q]; }
  uint32_t nonneg() const {
    uint32_t m = 0;
    for (int q = 0; q < MAX_G; ++q) m |= static_cast<uint32_t>(v[q] >= 0) << q;
    return m;
  }
};
#endif
#define SB_OPERANDS(q) for (int q = tid(); q < OPN; q += SB_T)

// a % n for a >= 0 and 0 < n <= 64, in 32-bit steps: a = hi 2^32 + lo
SB_DEV int mod_small(int64_t a, int n) {
  const uint32_t un = static_cast<uint32_t>(n);
  const uint32_t hi = static_cast<uint32_t>(static_cast<uint64_t>(a) >> 32) % un;
  const uint32_t lo = static_cast<uint32_t>(a) % un;
  const uint32_t p32 = (0u - un) % un;   // 2^32 % n
  return static_cast<int>((hi * p32 + lo) % un);
}

// ---------------------------------------------------------------- the image
struct Dims {
  int W, NWF, A, E, P, S, PS, DD, G, R, PRS, RVW, LS, IVS, IW, PF, C, GV, MW, CW, RV1;
};

SB_DEV Dims dims_of(const int* d) {
  Dims D;
  D.W = d[D_W]; D.NWF = d[D_NWF]; D.A = d[D_A]; D.E = d[D_E]; D.P = d[D_P]; D.S = d[D_S];
  D.PS = d[D_PS]; D.DD = d[D_DD]; D.G = d[D_G]; D.R = d[D_R]; D.PRS = d[D_PRS];
  D.RVW = d[D_RVW]; D.LS = d[D_LS]; D.IVS = d[D_IVS]; D.IW = d[D_IW]; D.PF = d[D_PF];
  D.C = d[D_C]; D.GV = d[D_GV]; D.MW = d[D_MW]; D.CW = d[D_CW]; D.RV1 = d[D_RV1];
  return D;
}

// Byte offsets of a lane's image (-1: not imaged on this route), each
// section 16-byte aligned, in this order; `bytes` is its size.
struct Image {
  int64_t wf, cf, pf, col, rck, rcs, bd, rvt, rvm, act, res, rmap, meta, ivt, ivregs, ivlat,
      bytes;
};

struct Packer {
  int64_t at = 0;
  SB_HD int64_t put(int64_t n) {
    const int64_t o = at;
    at = (at + n + 15) / 16 * 16;
    return o;
  }
};

SB_HD Image image_of(const int* d, int route) {
  const int64_t W = d[D_W];
  Packer p;
  Image im;
  im.wf = p.put(W * d[D_NWF] * 8);
  im.cf = p.put(W * d[D_CW] * 8);
  im.pf = p.put(int64_t(d[D_PF]) * 8);
  im.col = p.put(int64_t(d[D_C]) * 8);
  im.rck = p.put(int64_t(d[D_E]) * 8);
  im.rcs = p.put(int64_t(d[D_E]) * 8);
  im.bd = p.put(int64_t(NCAT) * 8);
  const bool on_chip = route == R_SHARED;   // rv and the tables in the image
  im.rvt = on_chip ? p.put(W * d[D_RVW] * 8) : -1;
  im.rvm = on_chip ? p.put(W * d[D_RVW]) : -1;
  im.act = p.put(int64_t(d[D_A]) * 4);
  im.res = p.put(W);
  // an RFC chunk's key index: key (warp, register) -> its entry, or -1
  im.rmap = p.put(d[D_E] > 1 ? W * (d[D_R] + 1) * 4 : 0);
  im.meta = on_chip ? p.put(int64_t(d[D_P] + 1) * d[D_MW] * 4) : -1;
  im.ivt = on_chip ? p.put(int64_t(d[D_IVS] + 1) * 4 * 4) : -1;
  im.ivregs = on_chip ? p.put(int64_t(d[D_IVS] + 1) * d[D_GV] * 4) : -1;
  im.ivlat = p.put(int64_t(d[D_IVS] + 1) * 8);   // each interval's latency, reckoned once
  im.bytes = p.at;
  return im;
}

// ------------------------------------------------------------------ one lane
// RT: the route, so that every access's memory space is known at compile time.
template <int RT>
struct Lane {
  // tables and constants
  const int32_t* meta;
  const int32_t* ivt;
  const int32_t* ivregs;
  int endpc, iw, nw, rcap, acap, tcap, ecap;
  double mrfc, xbar, rate, l1h, banksf, aluf, memf, drint, wlat, rl0, alw;
  int64_t brf_i, l1c, thr, seed, maxc;
  bool cached, edge, bl, rfc, fam;
  // the image (and `rv`'s plane on the global route)
  int64_t* wf;
  double* cf;
  int64_t* pf;
  int64_t* col;
  int64_t* rck;     // the RFC table's keys
  int64_t* rcs;     // and stamps
  int64_t* bd;
  double* rvt;      // W x RVW register times
  uint8_t* rvm;     // and memory flags
  double* rvg;      // global: the plane, W x RV1 x 2
  int32_t* act;
  uint8_t* res;
  int32_t* rmap;      // an RFC lane's key index: key -> its entry or -1
  double* ivlat;      // each interval's prefetch latency (`iv_lat`)
  int nkeys;          // the keys it covers: W (R + 1)
  int rvw, rv1;
  // the stamps of RFC entries u * SB_T + tid() (u < RC_PER_T, below
  // RC_REG), in registers for the whole run (INT64_MAX past E); the image
  // holds the keys, and the stamps of the entries past RC_REG
  int64_t rs[RC_PER_T];
  // scalars: the same in every thread
  int64_t cycle, rstamp;
  int na, nr, ptr, rcnt;
  bool alive, budget;
  double tok, dnext;
  int64_t mlast;
  int64_t ch, ca, cm, cpo, cpc, cps, cwb, cact;

  SB_DEV double rv_time(int w, int r) const {
    return RT == R_GLOBAL ? rvg[(static_cast<int64_t>(w) * rv1 + r) * 2] : rvt[w * rvw + r];
  }
  SB_DEV bool rv_mem(int w, int r) const {
    return RT == R_GLOBAL ? rvg[(static_cast<int64_t>(w) * rv1 + r) * 2 + 1] > 0.0
                             : rvm[w * rvw + r] != 0;
  }
  SB_DEV void rv_set(int w, int r, double t, bool m) {
    if (RT == R_GLOBAL) {
      double* p = rvg + (static_cast<int64_t>(w) * rv1 + r) * 2;
      p[0] = t;
      p[1] = m ? 1.0 : 0.0;
    } else {
      rvt[w * rvw + r] = t;
      rvm[w * rvw + r] = m;
    }
  }
  SB_DEV void rv_raise(int w, int r, double t) {
    double* p = RT == R_GLOBAL ? rvg + (static_cast<int64_t>(w) * rv1 + r) * 2
                                  : rvt + w * rvw + r;
    *p = mx(*p, t);
  }
};

template <class LN>
SB_DEV const int32_t* meta_row(const LN& L, const Dims& D, int64_t pc) {
  return L.meta + (pc < D.P ? pc : D.P) * D.MW;
}

// an interval's prefetch latency (reference :729 and :916): the product
// rounded, the quotient rounded, then their sum
SB_DEV double iv_lat(const int32_t* ivt, int ii, double mrfc, double xbar) {
  return static_cast<double>(ivt[ii * 4 + 0]) * mrfc +
         static_cast<double>(ivt[ii * 4 + 1]) / xbar;
}

// the readiness row of warp w at pc `pcc` (reference :664-683), every
// thread the same: the sources' times read at once, then their max and the
// memory sources' max
template <class LN>
SB_DEV void refresh_cf(LN& L, const Dims& D, int w, int64_t pcc) {
  const int32_t* m = meta_row(L, D, pcc);
  double* c = L.cf + w * D.CW;
  double tmax = 0.0, cmem = 0.0;   // every time is >= +0.0
  const int n = D.S + D.PS;
  if (n <= 8) {
    // the sources' rows, then their times and flags, each read at once
    // (indices past n repeat the last source and are not used)
    int rows[8];
    double t[8];
    bool mem[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = j < n ? j : n - 1;
      rows[j] = jj < D.S ? m[M_S + jj] : D.R + 1 + m[M_S + jj];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      t[j] = L.rv_time(w, rows[j]);
      mem[j] = L.rv_mem(w, rows[j]);
    }
    double all[8], from_mem[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      all[j] = j < n ? t[j] : 0.0;
      from_mem[j] = j < D.S && mem[j] ? t[j] : 0.0;
      if (j < n) c[2 + j] = t[j];
    }
    tmax = max8(all);
    cmem = max8(from_mem);
  } else {
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const int row = j < D.S ? m[M_S + j] : D.R + 1 + m[M_S + j];
      const double t = L.rv_time(w, row);
      tmax = mx(tmax, t);
      if (j < D.S && L.rv_mem(w, row)) cmem = mx(cmem, t);
      c[2 + j] = t;
    }
  }
  c[0] = tmax;
  c[1] = cmem;
}

// one prefetch op into the inflight-slot array (reference :685-694): the
// first earliest-free slot
template <class LN>
SB_DEV int64_t prefetch_slot(LN& L, const Dims& D, double lat) {
  int64_t freet = INT64_MAX;
  int slot = INT_MAX;
#pragma unroll 1
  for (int j = tid(); j < D.PF; j += SB_T)
    if (L.pf[j] < freet) {
      freet = L.pf[j];
      slot = j;
    }
  team_argmin(freet, slot);
  const int64_t done = static_cast<int64_t>(static_cast<double>(mx(L.cycle, freet)) + lat);
  sync();
  L.pf[slot] = done;
  return done;
}

// a fired prefetch: its counters, and its interval's registers maxed up to
// their landing time (reference :696-703, :730-736)
template <class LN>
SB_DEV int64_t fire_prefetch(LN& L, const Dims& D, int w, int ii) {
  const double lat = L.ivlat[ii];
  const int64_t done = prefetch_slot(L, D, lat);
  L.cpo += 1;
  L.cpc += static_cast<int64_t>(lat);
  L.cps += done - L.cycle;
  L.cm += L.ivt[ii * 4 + 1];
  const double dt = static_cast<double>(done);
  if (tid() == 0) {
#pragma unroll 1
    for (int j = 0; j < D.GV; ++j) {
      const int r = L.ivregs[ii * D.GV + j];
      if (r >= 0) L.rv_raise(w, r, dt);
    }
  }
  sync();
  return done;
}

// Greedy lowest-wid-ready activation (reference :705-755): of `cand`, the
// lane's READY resident warps, the first `acap - na` in wid order, each
// with its activation prefetch where the lane is cached; every thread walks
// them in order.
template <class LN>
SB_DEV void activation(LN& L, const Dims& D, uint64_t cand) {
  const int n = mn(popc(cand), mx(L.acap - L.na, 0));
  if (n > 0) sync();   // every thread's reads of the rows (`ready_warps`) done
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int w = ctz(cand);
    cand &= cand - 1;
    L.act[L.na + i] = w;
    int64_t* row = L.wf + w * D.NWF;
    if (!L.cached) {
      row[F_ST] = ACTIVE;
      continue;
    }
    // _start_prefetch(force=True)
    const int64_t pcc = mn(row[F_PC], static_cast<int64_t>(D.P));
    const int iid = meta_row(L, D, pcc)[M_IVPC];
    const bool go = iid >= 0;
    const int ii = go ? iid : D.IVS;
    if (go && L.ivt[ii * 4 + 3] > 0) {
      const int64_t done = fire_prefetch(L, D, w, ii);
      row[F_ST] = PREFETCH;
      row[F_RA] = done;
      row[F_IV] = iid;
      refresh_cf(L, D, w, pcc);
    } else {
      row[F_ST] = ACTIVE;
      if (go) row[F_IV] = iid;
    }
  }
  L.na += n;
  L.cact += n;
}

// the lane's READY resident warps, a bit each
template <class LN>
SB_DEV uint64_t ready_warps(const LN& L, const Dims& D) {
  uint64_t cand = 0;
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const int w = i * SB_T + tid();
    bool p = false;
    if (w < D.W) {
      const bool r = L.res[w] != 0;
      const int64_t st = L.wf[w * D.NWF + F_ST];
      p = r & (st == READY);
    }
    cand |= static_cast<uint64_t>(ballot(p)) << (i * SB_T);
  }
  return cand;
}

// The LRU victim: the entry with the oldest stamp, the first on ties.
template <class LN>
SB_DEV int lru_victim(const LN& L, const Dims& D) {
  int64_t oldest = INT64_MAX;
  int slot = INT_MAX;
#pragma unroll
  for (int u = 0; u < RC_PER_T; ++u)
    if (L.rs[u] < oldest) {
      oldest = L.rs[u];
      slot = u * SB_T + tid();
    }
#pragma unroll 1
  for (int e = RC_REG + tid(); e < D.E; e += SB_T)
    if (L.rcs[e] < oldest) {
      oldest = L.rcs[e];
      slot = e;
    }
  team_argmin(oldest, slot);
  return slot;
}

// entry e's stamp raised to at least t, its owner's register or the image
template <class LN>
SB_DEV void rc_raise(LN& L, int e, int64_t t) {
  if (e >= RC_REG) {
    const int64_t v = mx(L.rcs[e], t);
    sync();
    L.rcs[e] = v;
    return;
  }
#pragma unroll
  for (int u = 0; u < RC_PER_T; ++u)
    if (u * SB_T + tid() == e) L.rs[u] = mx(L.rs[u], t);
}

// entry e set to (key k, stamp t)
template <class LN>
SB_DEV void rc_set(LN& L, int e, int64_t k, int64_t t) {
  L.rck[e] = k;
  if (e >= RC_REG) {
    L.rcs[e] = t;
    return;
  }
#pragma unroll
  for (int u = 0; u < RC_PER_T; ++u)
    if (u * SB_T + tid() == e) L.rs[u] = t;
}

// The _issue body for the selected warp (reference :757-944).
template <class LN>
SB_DEV void issue_one(LN& L, const Dims& D, int wsel, double cycf, bool& happened,
                      bool& sfail) {
  int64_t* row = L.wf + wsel * D.NWF;
  const int64_t pcs = row[F_PC];
  const int32_t* m = meta_row(L, D, pcs);
  const int kind = m[M_KIND];
  const bool bra = kind == OP_BRA, ext = kind == OP_EXIT, opnd = !bra && !ext;
  const bool is_ld = kind == OP_LD, is_set = kind == OP_SET;
  const int64_t nacc = m[M_NACC];
  const int m_ps = M_S + D.S, m_d = m_ps + D.PS, m_g = m_d + D.DD;
  const int64_t key0 = static_cast<int64_t>(wsel) * (D.R + 1);   // the warp's keys: key0 + r
  // RFC classification against the pre-issue cache state (:769-782): the
  // operands (`valid`), those in the table (`found`) and the entry holding
  // each (`pos`, :825), read from the key's index, one load an operand
  const bool classify = L.rfc && opnd;
  uint32_t valid = 0, found = 0;
  Spread<int> pos;
  Spread<int64_t> key;
  if (classify) {
#pragma unroll 1
    for (int i = 0; i < D.G; ++i)
      if (m[m_g + i] >= 0) valid |= 1u << i;
    SB_OPERANDS(q) {
      const bool v = (valid >> q) & 1u;
      key.at(q) = v ? key0 + m[m_g + q] : -2;
      pos.at(q) = v ? L.rmap[key.at(q)] : -1;
    }
    found = pos.nonneg();
  }
  const int64_t n_hit = popc(found), n_miss = popc(valid & ~found);
  const int64_t n_bw = L.bl ? (opnd ? nacc : 0) : (L.rfc ? n_miss : 0);
  // the operand collector: first free slot (:798-802)
  int64_t cfree = INT64_MAX;
  int cslot = INT_MAX;
#pragma unroll 1
  for (int j = tid(); j < D.C; j += SB_T)
    if (L.col[j] < cfree) {
      cfree = L.col[j];
      cslot = j;
    }
  team_argmin(cfree, cslot);
  bool ok = opnd && cfree <= L.cycle;
  // MRF bandwidth token bucket, refilled only on a non-zero request (:783-797)
  if (opnd && n_bw > 0) {
    double tok = L.tok;
    if (L.cycle > L.mlast) {
      const double gain = L.rate * static_cast<double>(L.cycle - L.mlast);
      tok = mn(L.banksf, L.tok + gain);
      L.mlast = L.cycle;
    }
    const double need = static_cast<double>(n_bw);
    const bool bw_ok = tok >= need;
    L.tok = bw_ok ? tok - need : tok;
    ok = ok && bw_ok;
  }
  const int64_t cnew = ok ? L.cycle + L.brf_i : cfree;
  sync();
  L.col[cslot] = cnew;
  sfail = opnd && !ok;
  if (ok) {
    L.cm += L.bl ? nacc : (L.rfc ? n_miss : 0);
    if (L.rfc || L.fam) L.ca += nacc;
    L.ch += L.rfc ? n_hit : (L.fam ? nacc : 0);
  }
  if (ok && L.rfc) {
    // LRU: move every pre-state hit to the end in operand order (:815-829):
    // hit i's stamp at least rstamp + the hits before it
#pragma unroll 1
    for (int i = 0; i < D.G; ++i)
      if ((found >> i) & 1u) rc_raise(L, pos.get(i), L.rstamp + popc(found & ((1u << i) - 1u)));
    L.rstamp += n_hit;
    // then insert the misses in operand order, evicting the oldest stamp
    // (:830-845): an operand whose key an earlier insert wrote is present
    // (the index says so), one whose key it evicted is not
#pragma unroll 1
    for (int i = 0; i < D.G; ++i) {
      if (!((valid >> i) & 1u)) continue;
      const int64_t k = key.get(i);
      if (L.rmap[k] >= 0) continue;
      const bool full = L.rcnt >= L.ecap;
      const int s = mn(full ? lru_victim(L, D) : L.rcnt, D.E - 1);
      const int64_t old = L.rck[s];
      sync();
      if (old >= 0 && old < L.nkeys) L.rmap[old] = -1;
      L.rmap[k] = s;
      rc_set(L, s, k, L.rstamp);
      L.rstamp += 1;
      if (!full) L.rcnt += 1;
    }
  }
  const double read_lat = (L.rfc && n_miss > 0) ? L.mrfc : L.rl0;
  const double rl = cycf + read_lat;
  // memory latency, which only a load reads: jitter hash (in uint64) and
  // the DRAM queue (:846-858)
  const bool ldo = ok && is_ld;
  const int64_t mops = row[F_MO];
  int64_t mlat = 0;
  if (is_ld) {
    const uint64_t hu = static_cast<uint64_t>(wsel) * 2654435761ull +
                        static_cast<uint64_t>(L.seed) * 97ull +
                        static_cast<uint64_t>(mops) * 40503ull;
    const int64_t h = static_cast<int64_t>(hu & 0xFFFFull);
    if (static_cast<double>(h) / 65535.0 < L.l1h) {
      mlat = L.l1c;
    } else {
      const double spread = (static_cast<double>(h >> 3) / 8191.0 - 0.5) * 0.6;
      const double dstart = mx(cycf, L.dnext);
      if (ldo) L.dnext = dstart + L.drint;
      mlat = static_cast<int64_t>((dstart - cycf) + L.memf * (1.0 + spread));
    }
  }
  // writeback chain and the dst register / predicate writes (:859-880)
  const double da = is_set ? rl + L.aluf
                           : (is_ld ? rl + (static_cast<double>(mlat) + L.wlat) : rl + L.alw);
  if (ok && !is_set) {
#pragma unroll 1
    for (int d = 0; d < D.DD; ++d) {
      const int r = m[m_d + d];
      if (r < D.R) L.rv_set(wsel, r, da, is_ld);
    }
  } else if (ok) {
    const int pd = m[M_PDST];
    if (pd < D.PRS) L.rv_set(wsel, D.R + 1 + pd, da, false);
  }
  happened = bra || ext || ok;
  // branch resolution (:882-904)
  const int lsl = m[M_LSL], dsl = m[M_DSL];
  const int f_dc = F_LC + D.LS + 1;
  const bool uncond = m[m_ps] >= D.PRS;
  const bool isl = bra && lsl < D.LS;
  const int64_t c = row[F_LC + lsl] + 1;
  const bool tkl = c < m[M_TRIPS];
  const bool isd = bra && !uncond && lsl >= D.LS;
  const int64_t v = row[f_dc + dsl];
  const uint64_t hh = static_cast<uint64_t>(wsel) * 31ull + static_cast<uint64_t>(L.seed) +
                      static_cast<uint64_t>(v) * 17ull;
  const bool taken = uncond || (isl ? tkl : (hh & 1ull) == 1ull);
  const int64_t npc = bra ? (taken ? static_cast<int64_t>(m[M_TGT]) : pcs + 1)
                          : (ok ? pcs + 1 : pcs);
  const int64_t npce = ext ? pcs : npc;
  // edge prefetch at the post-update pc (:905-923)
  int64_t st_new = row[F_ST], iv_new = row[F_IV], ra_new = row[F_RA];
  if (L.edge && (bra || ok) && npc < L.endpc) {
    const int iid = meta_row(L, D, npce)[M_IVPC];
    if (iid >= 0 && iid != row[F_IV]) {
      iv_new = iid;
      if (L.ivt[iid * 4 + 3] > 0) {
        ra_new = fire_prefetch(L, D, wsel, iid);
        st_new = PREFETCH;
      }
    }
  }
  // the warp-family row (:924-942) and its readiness row
  const int64_t issues = row[F_IS] + happened;
  sync();
  if (isl) row[F_LC + lsl] = tkl ? c : 0;
  if (isd) row[f_dc + dsl] = v + 1;
  row[F_ST] = ext ? int64_t(DONE) : st_new;
  row[F_PC] = npce;
  row[F_IV] = iv_new;
  row[F_RA] = ra_new;
  row[F_IS] = issues;
  row[F_MO] = mops + ldo;
  if (happened) refresh_cf(L, D, wsel, mn(npce, static_cast<int64_t>(D.P)));
}

// an active position's view for the issue slots: status, end flag, and its
// readiness row's first two columns
template <class LN>
SB_DEV void load_position(const LN& L, const Dims& D, int w, bool posv, int& st,
                          bool& atend, double& ready_at, double& blocked) {
  const int64_t* row = L.wf + w * D.NWF;
  st = static_cast<int>(row[F_ST]);
  atend = posv && row[F_PC] >= L.endpc;
  ready_at = L.cf[w * D.CW];
  blocked = posv ? L.cf[w * D.CW + 1] : 0.0;
}

// The issue slots over the frozen active list, then the retirement and
// admission (reference :962-1045); `issue_any` and `strct` for the cycle's
// category.
template <class LN>
SB_DEV void issue_and_retire(LN& L, const Dims& D, bool& issue_any, bool& strct) {
  // issue slots over the frozen active list, round-robin ranks (:962-1005);
  // each thread's positions a = i * SB_T + tid() are held in registers
  const int na = L.na;
  const int nz = mx(na, 1);
  const int rot = mod_small(L.cycle, nz);   // pymod: the cycle is >= 0
  const double cycf = static_cast<double>(L.cycle);
  const double thr = static_cast<double>(L.cycle + L.thr);
  int wida[PER_T], st[PER_T];
  uint32_t rank[PER_T];
  bool atend[PER_T], ndacc[PER_T];
  double ready_at[PER_T], blocked[PER_T], msacc[PER_T];
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const int a = i * SB_T + tid();
    const bool posv = a < na;
    wida[i] = posv ? L.act[a] : 0;
    const int r = a - rot;                  // in (-nz, nz): pymod(a - rot, nz)
    rank[i] = posv ? static_cast<uint32_t>(r < 0 ? r + nz : r) : NO_RANK;
    load_position(L, D, wida[i], posv, st[i], atend[i], ready_at[i], blocked[i]);
    if (!posv) st[i] = -1;
    ndacc[i] = false;
    msacc[i] = 0.0;
  }
#pragma unroll 1
  for (int j = 0; j < D.IW; ++j) {
    const bool slot_on = j < L.iw;
    // the ready position of the smallest rank: (rank, position) in one word
    uint32_t mine = NO_RANK;
    bool ready[PER_T];
#pragma unroll
    for (int i = 0; i < PER_T; ++i) {
      ready[i] = st[i] == ACTIVE && !atend[i] && ready_at[i] <= cycf;
      if (ready[i] && slot_on)
        mine = mn(mine, (rank[i] << 8) | static_cast<uint32_t>(i * SB_T + tid()));
    }
    const uint32_t pick = team_min_u32(mine);
    const uint32_t best = pick == NO_RANK ? NO_RANK : pick >> 8;
#pragma unroll
    for (int i = 0; i < PER_T; ++i) {
      const bool visited = slot_on && rank[i] <= best;   // NO_RANK: not on the list
      const bool isact = st[i] == ACTIVE;
      ndacc[i] = ndacc[i] || (visited && isact && atend[i]);
      // blocked on long memory: a deactivation candidate (:991-1001)
      if (L.cached && visited && isact && !atend[i] && !ready[i] && blocked[i] > thr)
        msacc[i] = mx(msacc[i], blocked[i]);
    }
    // a slot that issues nothing changes nothing, so neither does a later one
    if (pick == NO_RANK) break;
    const int a = static_cast<int>(pick & 0xffu);
    bool h = false, sf = false;
    issue_one(L, D, L.act[a], cycf, h, sf);
    issue_any = issue_any || h;
    strct = strct || sf;
#pragma unroll
    for (int i = 0; i < PER_T; ++i)
      if (i * SB_T + tid() == a)
        load_position(L, D, wida[i], true, st[i], atend[i], ready_at[i], blocked[i]);
  }
  // deferred DONE marks (:1006-1008), then the two-level deactivation of
  // the stalled warps (:1009-1022)
  sync();   // every thread's reads of the active list and the rows done
  uint32_t nwb = 0;
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    int64_t* row = L.wf + wida[i] * D.NWF;
    if (ndacc[i]) {
      row[F_ST] = st[i] = DONE;
    } else if (L.cached && msacc[i] > 0.0 && st[i] == ACTIVE) {
      const int ii = row[F_IV] >= 0 ? static_cast<int>(row[F_IV]) : D.IVS;
      nwb += L.ivt[ii * 4 + 2];
      row[F_ST] = st[i] = WAIT;
      row[F_RA] = static_cast<int64_t>(msacc[i]);
      row[F_IV] = -1;
    }
  }
  if (L.cached) {
    const int64_t nwb_all = team_sum_u32(nwb);
    L.cwb += nwb_all;
    L.cm += nwb_all;
  }
  // compact the active list, retire DONE warps, admit pending ones (:1023-1045)
  uint64_t keep = 0, donem = 0;
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const bool posv = st[i] >= 0;
    keep |= static_cast<uint64_t>(ballot(posv && st[i] != WAIT && st[i] != DONE)) << (i * SB_T);
    donem |= static_cast<uint64_t>(ballot(st[i] == DONE)) << (i * SB_T);
  }
  const int newna = popc(keep);
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const int a = i * SB_T + tid();
    if ((keep >> a) & 1ull) L.act[popc(keep & ((uint64_t(1) << a) - 1))] = wida[i];
    if ((donem >> a) & 1ull) L.res[wida[i]] = 0;
  }
#pragma unroll 1
  for (int p = tid(); p < D.A; p += SB_T)
    if (p >= newna) L.act[p] = 0;
  L.na = newna;
  L.nr -= popc(donem);
  const int nadm = mx(mn(L.nw - L.ptr, L.rcap - L.nr), 0);
#pragma unroll 1
  for (int w = tid(); w < D.W; w += SB_T)
    if (w >= L.ptr && w < L.ptr + nadm) L.res[w] = 1;
  L.nr += nadm;
  L.ptr += nadm;
  sync();
}

// One tick of one lane (reference :946-1097), the lane alive.
template <class LN>
SB_DEV void tick(LN& L, const Dims& D) {
  // cycle-budget watchdog (:948-952): the lane stops at this cycle
  if (L.maxc > 0 && L.cycle > L.maxc) {
    L.budget = true;
    L.alive = false;
    return;
  }
  // wake: WAIT->READY, PREFETCH->ACTIVE once ready_at arrives (:954-960),
  // and the READY resident warps for the activation
  uint64_t cand = 0;
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const int w = i * SB_T + tid();
    bool p = false;
    if (w < D.W) {
      int64_t* row = L.wf + w * D.NWF;
      const bool r = L.res[w] != 0;
      int64_t st = row[F_ST];
      const int64_t ra = row[F_RA];
      if (r && ra <= L.cycle) {
        if (st == WAIT) row[F_ST] = st = READY;
        else if (st == PREFETCH) row[F_ST] = st = ACTIVE;
      }
      p = r && st == READY;
    }
    cand |= static_cast<uint64_t>(ballot(p)) << (i * SB_T);
  }
  sync();
  activation(L, D, cand);
  bool issue_any = false, strct = false;
  issue_and_retire(L, D, issue_any, strct);
  activation(L, D, ready_warps(L, D));
  // terminate a finished lane (:1050-1053)
  if (L.nr == 0 && L.ptr >= L.nw) {
    L.alive = false;
    return;
  }
  const double cycf = static_cast<double>(L.cycle);
  // classify the zero-issue cycle, find the next event (:1054-1092).  The
  // next event's cycle is the truncation of the earliest time, which is the
  // earliest of the truncations (times are >= 0 and below 2^53).
  uint32_t saw = 0;                  // 1: a PREFETCH warp, 2: mem, 4: dep
  int64_t next = INT64_MAX;          // INT64_MAX: no event (the reference's inf)
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const int w = i * SB_T + tid();
    if (w >= D.W) continue;
    const int64_t* row = L.wf + w * D.NWF;
    const double* cfw = L.cf + w * D.CW;
    const int64_t st_w = row[F_ST], pc = row[F_PC], ra = row[F_RA];
    const bool r = L.res[w] != 0;
    // the readiness row read at once (columns past its end repeat the last)
    const int n = D.CW - 2;
    double cv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) cv[j] = cfw[2 + (j < n ? j : n - 1)];
    const double c0 = cfw[0], c1 = cfw[1];
    if (st_w == PREFETCH) saw |= 1u;
    if (st_w == ACTIVE && pc < L.endpc) {
      if (c1 > cycf) saw |= 2u;
      if (c0 > cycf) saw |= 4u;
      double later[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) later[j] = j < n && cv[j] > cycf ? cv[j] : INFINITY;
      double t = min8(later);
#pragma unroll 1
      for (int j = 8; j < n; ++j)
        if (cfw[2 + j] > cycf) t = mn(t, cfw[2 + j]);
      if (t != INFINITY) next = mn(next, static_cast<int64_t>(t));
    }
    if (r && (st_w == WAIT || st_w == PREFETCH))
      next = mn(next, static_cast<int64_t>(static_cast<double>(ra)));
  }
  int64_t colf = INT64_MAX;
#pragma unroll 1
  for (int j = tid(); j < D.C; j += SB_T) colf = mn(colf, L.col[j]);
  saw = team_or_u32(saw);
  colf = team_min(colf);
  next = mn(team_min(next), colf > L.cycle ? colf : INT64_MAX);
  const bool drain = L.ptr >= L.nw && L.nr < L.tcap;
  const int cat = drain ? CAT_DRAIN : strct ? CAT_BANK : (saw & 1u) ? CAT_PREFETCH
                : (saw & 2u) ? CAT_MEM : (saw & 4u) ? CAT_ALU_DEP : CAT_IDLE;
  const int64_t cyc1 = L.cycle + 1;
  const int64_t nxt = next == INT64_MAX ? cyc1 : mx(next, cyc1);
  const int64_t delta = issue_any ? 1 : nxt - L.cycle;
  if (tid() == 0) L.bd[issue_any ? CAT_ISSUE : cat] += delta;   // read at the end alone
  L.cycle += delta;
  sync();
}

template <class X> SB_DEV X* plane(const Args& a, Plane p, int k) {
  return static_cast<X*>(a.planes[p]) + a.lane_stride[p] * k;
}

// n elements from src to dst, strided over the team
template <class X, class Y> SB_DEV void team_copy(X* dst, const Y* src, int64_t n) {
  for (int64_t i = tid(); i < n; i += SB_T) dst[i] = static_cast<X>(src[i]);
}

// Lane k, every tick to completion in its image; returns its tick count.
template <int RT>
SB_DEV int64_t run_lane(const Args& a, int k, unsigned char* image) {
  const Dims D = dims_of(a.dims);
  Lane<RT> L;
  L.alive = *plane<const uint8_t>(a, PL_alive, k) != 0;
  if (!L.alive) return 0;
#define SB_LOAD(field, T) L.field = *plane<const T>(a, PL_##field, k)
  SB_LOAD(endpc, int32_t); SB_LOAD(iw, int32_t); SB_LOAD(nw, int32_t);
  SB_LOAD(rcap, int32_t); SB_LOAD(acap, int32_t); SB_LOAD(tcap, int32_t);
  SB_LOAD(ecap, int32_t); SB_LOAD(mrfc, double); SB_LOAD(xbar, double);
  SB_LOAD(rate, double); SB_LOAD(l1h, double); SB_LOAD(banksf, double);
  SB_LOAD(aluf, double); SB_LOAD(memf, double); SB_LOAD(drint, double);
  SB_LOAD(wlat, double); SB_LOAD(brf_i, int64_t); SB_LOAD(l1c, int64_t);
  SB_LOAD(thr, int64_t); SB_LOAD(seed, int64_t); SB_LOAD(maxc, int64_t);
  SB_LOAD(cycle, int64_t); SB_LOAD(na, int32_t); SB_LOAD(nr, int32_t);
  SB_LOAD(ptr, int32_t); SB_LOAD(tok, double); SB_LOAD(dnext, double);
  SB_LOAD(mlast, int64_t); SB_LOAD(rstamp, int64_t); SB_LOAD(rcnt, int32_t);
  SB_LOAD(ch, int64_t); SB_LOAD(ca, int64_t); SB_LOAD(cm, int64_t);
  SB_LOAD(cpo, int64_t); SB_LOAD(cpc, int64_t); SB_LOAD(cps, int64_t);
  SB_LOAD(cwb, int64_t); SB_LOAD(cact, int64_t);
#undef SB_LOAD
  L.cached = *plane<const uint8_t>(a, PL_cached, k) != 0;
  L.edge = *plane<const uint8_t>(a, PL_edge, k) != 0;
  L.bl = *plane<const uint8_t>(a, PL_bl, k) != 0;
  L.rfc = *plane<const uint8_t>(a, PL_rfc, k) != 0;
  L.fam = *plane<const uint8_t>(a, PL_fam, k) != 0;
  L.budget = *plane<const uint8_t>(a, PL_budget, k) != 0;
  const bool ideal = *plane<const uint8_t>(a, PL_ideal, k) != 0;
  // the read latency of a non-RFC read (the reference's `read_lat` chain)
  L.rl0 = ideal ? *plane<const double>(a, PL_brf_f, k)
                : L.bl ? L.mrfc : *plane<const double>(a, PL_rfcc, k);
  L.alw = L.aluf + L.wlat;
  L.rvw = D.RVW;
  L.rv1 = D.RV1;
  // the image: carve it, then copy the lane's rows in
  const Image im = image_of(a.dims, RT);
  L.wf = reinterpret_cast<int64_t*>(image + im.wf);
  L.cf = reinterpret_cast<double*>(image + im.cf);
  L.pf = reinterpret_cast<int64_t*>(image + im.pf);
  L.col = reinterpret_cast<int64_t*>(image + im.col);
  L.rck = reinterpret_cast<int64_t*>(image + im.rck);
  L.rcs = reinterpret_cast<int64_t*>(image + im.rcs);
  L.bd = reinterpret_cast<int64_t*>(image + im.bd);
  L.act = reinterpret_cast<int32_t*>(image + im.act);
  L.res = image + im.res;
  L.rmap = reinterpret_cast<int32_t*>(image + im.rmap);
  L.nkeys = D.E > 1 ? D.W * (D.R + 1) : 0;
  int64_t* wf = plane<int64_t>(a, PL_wf, k);
  double* cf = plane<double>(a, PL_cf, k);
  double* rv = plane<double>(a, PL_rv, k);
  int64_t* pf = plane<int64_t>(a, PL_pf, k);
  int64_t* col = plane<int64_t>(a, PL_col, k);
  int64_t* rc = plane<int64_t>(a, PL_rc, k);
  int64_t* bd = plane<int64_t>(a, PL_bd, k);
  int32_t* act = plane<int32_t>(a, PL_act, k);
  uint8_t* res = plane<uint8_t>(a, PL_res, k);
  const int64_t nrv = int64_t(D.W) * D.RVW;
  team_copy(L.wf, wf, int64_t(D.W) * D.NWF);
  team_copy(L.cf, cf, int64_t(D.W) * D.CW);
  team_copy(L.pf, pf, D.PF);
  team_copy(L.col, col, D.C);
  team_copy(L.bd, bd, NCAT);
  team_copy(L.act, act, D.A);
  team_copy(L.res, res, D.W);
  for (int e = tid(); e < D.E; e += SB_T) {
    L.rck[e] = rc[e * 2];
    L.rcs[e] = rc[e * 2 + 1];
  }
#pragma unroll
  for (int u = 0; u < RC_PER_T; ++u) {
    const int e = u * SB_T + tid();
    L.rs[u] = e < D.E ? rc[e * 2 + 1] : INT64_MAX;
  }
  // the key index: every key -1, then each entry's key, the first entry last
  for (int i = tid(); i < L.nkeys; i += SB_T) L.rmap[i] = -1;
  sync();
  for (int e = D.E - 1; e >= 0 && L.nkeys > 0 && tid() == 0; --e) {
    const int64_t k = L.rck[e];
    if (k >= 0 && k < L.nkeys) L.rmap[k] = e;
  }
  if (RT == R_GLOBAL) {
    L.rvg = rv;
  } else {
    L.rvt = reinterpret_cast<double*>(image + im.rvt);
    L.rvm = image + im.rvm;
    for (int64_t i = tid(); i < nrv; i += SB_T) {
      const int64_t g = (i / D.RVW * D.RV1 + i % D.RVW) * 2;
      L.rvt[i] = rv[g];
      L.rvm[i] = rv[g + 1] > 0.0;
    }
  }
  const int32_t* meta = plane<const int32_t>(a, PL_meta, k);
  const int32_t* ivt = plane<const int32_t>(a, PL_ivt, k);
  const int32_t* ivregs = plane<const int32_t>(a, PL_ivregs, k);
  if (RT == R_SHARED) {
    int32_t* m = reinterpret_cast<int32_t*>(image + im.meta);
    int32_t* t = reinterpret_cast<int32_t*>(image + im.ivt);
    int32_t* g = reinterpret_cast<int32_t*>(image + im.ivregs);
    team_copy(m, meta, int64_t(D.P + 1) * D.MW);
    team_copy(t, ivt, int64_t(D.IVS + 1) * 4);
    team_copy(g, ivregs, int64_t(D.IVS + 1) * D.GV);
    L.meta = m;
    L.ivt = t;
    L.ivregs = g;
  } else {
    L.meta = meta;
    L.ivt = ivt;
    L.ivregs = ivregs;
  }
  L.ivlat = reinterpret_cast<double*>(image + im.ivlat);
  for (int ii = tid(); ii <= D.IVS; ii += SB_T) L.ivlat[ii] = iv_lat(ivt, ii, L.mrfc, L.xbar);
  sync();
  const int64_t tmax = *plane<const int64_t>(a, PL_tmax, k);
  int64_t ticks = 0;
  while (L.alive && ticks <= tmax) {
    ++ticks;
    tick(L, D);
  }
  sync();
  // write the image back, and the scalars
  team_copy(wf, L.wf, int64_t(D.W) * D.NWF);
  team_copy(cf, L.cf, int64_t(D.W) * D.CW);
  team_copy(pf, L.pf, D.PF);
  team_copy(col, L.col, D.C);
  team_copy(bd, L.bd, NCAT);
  team_copy(act, L.act, D.A);
  team_copy(res, L.res, D.W);
#pragma unroll
  for (int u = 0; u < RC_PER_T; ++u) {
    const int e = u * SB_T + tid();
    if (e < D.E) L.rcs[e] = L.rs[u];
  }
  for (int e = tid(); e < D.E; e += SB_T) {
    rc[e * 2] = L.rck[e];
    rc[e * 2 + 1] = L.rcs[e];
  }
  if (RT != R_GLOBAL) {
    for (int64_t i = tid(); i < nrv; i += SB_T) {
      const int64_t g = (i / D.RVW * D.RV1 + i % D.RVW) * 2;
      rv[g] = L.rvt[i];
      rv[g + 1] = L.rvm[i] ? 1.0 : 0.0;
    }
  }
  if (tid() == 0) {
#define SB_STORE(field, T) *plane<T>(a, PL_##field, k) = L.field
    SB_STORE(cycle, int64_t); SB_STORE(na, int32_t); SB_STORE(nr, int32_t);
    SB_STORE(ptr, int32_t); SB_STORE(tok, double); SB_STORE(dnext, double);
    SB_STORE(mlast, int64_t); SB_STORE(rstamp, int64_t); SB_STORE(rcnt, int32_t);
    SB_STORE(ch, int64_t); SB_STORE(ca, int64_t); SB_STORE(cm, int64_t);
    SB_STORE(cpo, int64_t); SB_STORE(cpc, int64_t); SB_STORE(cps, int64_t);
    SB_STORE(cwb, int64_t); SB_STORE(cact, int64_t);
#undef SB_STORE
    *plane<uint8_t>(a, PL_alive, k) = L.alive;
    *plane<uint8_t>(a, PL_budget, k) = L.budget;
  }
  return ticks;
}

// widths the kernel takes; anything else is refused before a launch
bool takes(const Args& a) {
  const int* d = a.dims;
  return d[D_K] > 0 && d[D_W] > 0 && d[D_W] <= MAX_W && d[D_A] > 0 && d[D_A] <= MAX_W &&
         d[D_G] <= MAX_G && d[D_E] > 0 && d[D_PF] > 0 && d[D_C] > 0 && d[D_S] > 0 &&
         d[D_PS] > 0 && d[D_NCAT] == NCAT && d[D_CW] == 2 + d[D_S] + d[D_PS] &&
         d[D_MW] >= M_S + d[D_S] + d[D_PS] + d[D_DD] + d[D_G] &&
         d[D_NWF] == F_LC + d[D_LS] + 1 + d[D_DS] + 1 && d[D_RV1] > d[D_RVW] &&
         d[D_RVW] == d[D_R] + 1 + d[D_PRS] + 1 && a.route >= 0 && a.route < NROUTES &&
         a.image_bytes == image_of(d, a.route).bytes;
}

// A chunk's lanes are sorted shortest first, padding lanes last: block b
// takes lane K-1-b, so the padding returns at once and the longest start
// first.
SB_HD int lane_of_block(int K, int b) { return K - 1 - b; }

#if defined(__CUDACC__)
template <int RT>
__global__ void __launch_bounds__(32, 1) sim_batch_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char image[];
  const int64_t ticks = run_lane<RT>(a, lane_of_block(a.dims[D_K], blockIdx.x), image);
  if (threadIdx.x == 0 && ticks > 0)
    atomicMax(static_cast<unsigned long long*>(a.planes[PL_guard]),
              static_cast<unsigned long long>(ticks));
}

template <int RT>
int launch_route(const Args& a, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      sim_batch_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(a.image_bytes));
  if (err != cudaSuccess) return err;
  sim_batch_kernel<RT><<<a.dims[D_K], 32, a.image_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int RT>
int ctas_route(long long image_bytes, int* n) {
  const cudaError_t err = cudaFuncSetAttribute(
      sim_batch_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(image_bytes));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, sim_batch_kernel<RT>, 32,
                                                       image_bytes);
}
#endif

}  // namespace

extern "C" const char* sim_batch_layout() { return kLayout; }

// The image's bytes for the struct's widths on `route` (the host's
// reckoning, ops.image_bytes, must agree).
extern "C" long long sim_batch_image_bytes(const void* args, int route) {
  return image_of(static_cast<const Args*>(args)->dims, route).bytes;
}

extern "C" int sim_batch_lane_of_block(int K, int b) { return lane_of_block(K, b); }

#if defined(__CUDACC__)
// One launch runs the whole chunk: K CTAs of one warp, each with its lane's
// image.  `guard` must hold 0.
extern "C" int sim_batch_launch(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (!takes(a)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.route) {
    case R_SHARED: return launch_route<R_SHARED>(a, s);
    default: return launch_route<R_GLOBAL>(a, s);
  }
}

// The CTAs (lanes) of `route` with an image of `image_bytes` an SM holds at once.
extern "C" int sim_batch_ctas_per_sm(int route, long long image_bytes, int* n) {
  switch (route) {
    case R_SHARED: return ctas_route<R_SHARED>(image_bytes, n);
    case R_GLOBAL: return ctas_route<R_GLOBAL>(image_bytes, n);
    default: return cudaErrorInvalidValue;
  }
}
#else
// The same run on the host, lane after lane (a C++ compiler without CUDA),
// each lane's image in a host buffer.
extern "C" int sim_batch_run_host(const void* args) {
  const Args& a = *static_cast<const Args*>(args);
  if (!takes(a)) return 1;
  int64_t* guard = static_cast<int64_t*>(a.planes[PL_guard]);
  std::vector<uint64_t> buf((a.image_bytes + 7) / 8);
  unsigned char* image = reinterpret_cast<unsigned char*>(buf.data());
  const int K = a.dims[D_K];
  for (int b = 0; b < K; ++b) {
    const int k = lane_of_block(K, b);
    const int64_t ticks = a.route == R_SHARED ? run_lane<R_SHARED>(a, k, image)
                                              : run_lane<R_GLOBAL>(a, k, image);
    *guard = std::max(*guard, ticks);
  }
  return 0;
}
#endif
