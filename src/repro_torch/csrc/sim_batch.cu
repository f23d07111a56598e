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
// Its state stays in the global planes the host allocated (no repacking):
// a lane's rows are touched only by its own warp, so they live in its SM's
// L1.  Scalars (cycle, active count, residency pointers) are held in
// registers, the same value in every thread.  Loops over the simulated
// warps (W <= 64) and over the active list (A <= 64) are strided over the
// 32 threads, with ballots for the first-index picks and prefix counts and
// shuffles for the min/max/sum reductions.  What the reference orders
// (the activation pass in wid order, the inflight-prefetch slots taken in
// wid order, one issue slot after another, the RFC's LRU insert/evict in
// operand order) runs in that order on thread 0, only the scans of the
// RFC's table (128 entries) strided over the threads.  The activation is exact:
// no bound, no overflow flag, no snapshot, no rerun.  Each lane ticks while
// it is alive and its own tick count is <= tmax; the chunk's `guard` is the
// largest count over its lanes, which is the reference's chunk-wide count.
//
// What bounds it: a tick is a short dependent chain of small integer and
// float64 steps on one lane's rows, so a lane's time is latency (L1 hits,
// shuffles, thread 0's serial parts), not bytes or operations; the chunk's
// time is its longest lane's.  No roofline applies.
//
// Traps, each kept below:
// * float64: every site performs the reference's operations in its order.
//   This source is compiled with -fmad=false (kernels/_build.py), so no
//   product contracts into an FMA with the add that consumes it; `/` is the
//   IEEE quotient (the divisions by 65535 and 8191 included); a float to
//   int64 cast truncates toward zero, as torch's `.to(int64)` does.
// * int64 hashes are computed in uint64 (signed overflow is undefined in
//   C++ and wraps in PyTorch) and only their low bits are used.
// * `%` is Python's (torch.remainder): `pymod`.
// * argmin/argmax take the first index on ties; _BIG = 2^60 is "never".
//   Writes that the plain version sends to a trash row simply do not happen.
//
// Built for the host too (a C++ compiler without CUDA: one thread a lane,
// the same code), so that its logic can be held to the plain tick on a CPU.
#include <cstdint>
#include <cmath>
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define SB_DEV __device__ __forceinline__
#define SB_T 32
#else
#include <algorithm>
#define SB_DEV inline
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

struct Args {
  void* planes[NPLANES];
  long long lane_stride[NPLANES];   // elements between two lanes' rows (0: one scalar)
  int dims[NDIMS];
};

enum { ACTIVE, READY, WAIT, PREFETCH, DONE };
enum { OP_OTHER, OP_BRA, OP_EXIT, OP_SET, OP_LD };
enum { F_ST, F_PC, F_IV, F_RA, F_IS, F_MO, F_LC };
enum { M_KIND, M_NACC, M_PDST, M_TGT, M_TRIPS, M_LSL, M_DSL, M_IVPC, M_S };
enum { CAT_ISSUE, CAT_ALU_DEP, CAT_MEM, CAT_PREFETCH, CAT_BANK, CAT_IDLE, CAT_DRAIN, NCAT };

constexpr int64_t BIG = int64_t(1) << 60;
constexpr int MAX_W = 64;       // simulated warps a lane, and active-list width
constexpr int MAX_G = 16;       // operand registers an instruction
constexpr int PER_T = MAX_W / SB_T;

// ------------------------------------------------------------------ the team
// The threads that run one lane: a warp on the card, one thread on the host.
#if defined(__CUDACC__)
constexpr unsigned FULL = 0xffffffffu;
SB_DEV int tid() { return threadIdx.x; }
SB_DEV void sync() { __syncwarp(); }
SB_DEV uint32_t ballot(bool p) { return __ballot_sync(FULL, p); }
template <class X> SB_DEV X shfl_xor(X x, int o) { return __shfl_xor_sync(FULL, x, o); }
template <class X> SB_DEV X bcast(X x) { return __shfl_sync(FULL, x, 0); }
SB_DEV int popc(uint64_t m) { return __popcll(m); }
SB_DEV int ctz(uint64_t m) { return __ffsll(static_cast<long long>(m)) - 1; }
#else
inline int tid() { return 0; }
inline void sync() {}
inline uint32_t ballot(bool p) { return p ? 1u : 0u; }
template <class X> inline X shfl_xor(X x, int) { return x; }
template <class X> inline X bcast(X x) { return x; }
inline int popc(uint64_t m) { return __builtin_popcountll(m); }
inline int ctz(uint64_t m) { return __builtin_ctzll(m); }
#endif

template <class X> SB_DEV X mn(X a, X b) { return b < a ? b : a; }
template <class X> SB_DEV X mx(X a, X b) { return b > a ? b : a; }

template <class X> SB_DEV X team_min(X x) {
  for (int o = SB_T / 2; o > 0; o >>= 1) x = mn(x, shfl_xor(x, o));
  return x;
}
template <class X> SB_DEV X team_sum(X x) {
  for (int o = SB_T / 2; o > 0; o >>= 1) x += shfl_xor(x, o);
  return x;
}
SB_DEV bool team_any(bool p) { return ballot(p) != 0; }

// the first index of the smallest value over the team's (value, index) pairs
SB_DEV void team_argmin(int64_t& v, int& i) {
  for (int o = SB_T / 2; o > 0; o >>= 1) {
    const int64_t v2 = shfl_xor(v, o);
    const int i2 = shfl_xor(i, o);
    if (v2 < v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
}

// Python's `%` (torch.remainder) for a positive divisor
SB_DEV int64_t pymod(int64_t a, int64_t n) {
  const int64_t r = a % n;
  return r < 0 ? r + n : r;
}

// ------------------------------------------------------------------ one lane
struct Dims {
  int W, NWF, A, E, P, S, PS, DD, G, R, PRS, LS, IVS, IW, PF, C, GV, MW, CW, RV1;
};

struct Lane {
  // tables and constants
  const int32_t* meta;
  const int32_t* ivt;
  const int32_t* ivregs;
  int endpc, iw, nw, rcap, acap, tcap, ecap;
  double mrfc, xbar, rate, l1h, banksf, aluf, memf, drint, wlat, rl0, alw;
  int64_t brf_i, l1c, thr, seed, maxc;
  bool cached, edge, bl, rfc, fam;
  // planes
  int64_t* wf;
  double* cf;
  double* rv;
  int32_t* act;
  uint8_t* res;
  int64_t* pf;
  int64_t* col;
  int64_t* rc;
  // scalars: the same in every thread
  int64_t cycle, rstamp;
  int na, nr, ptr, rcnt;
  bool alive, budget;
  // thread 0's alone: changed only where thread 0 runs alone
  double tok, dnext;
  int64_t mlast;
  int64_t bd[NCAT];
  int64_t ch, ca, cm, cpo, cpc, cps, cwb, cact;
};

SB_DEV const int32_t* meta_row(const Lane& L, const Dims& D, int64_t pc) {
  return L.meta + (pc < D.P ? pc : D.P) * D.MW;
}

// an interval's prefetch latency (reference :729 and :916): the product
// rounded, the quotient rounded, then their sum
SB_DEV double iv_lat(const Lane& L, int ii) {
  return static_cast<double>(L.ivt[ii * 4 + 0]) * L.mrfc +
         static_cast<double>(L.ivt[ii * 4 + 1]) / L.xbar;
}

// the readiness row of warp w at pc `pcc` (reference :664-683)
SB_DEV void refresh_cf(Lane& L, const Dims& D, int w, int64_t pcc) {
  const int32_t* m = meta_row(L, D, pcc);
  const double* rvw = L.rv + static_cast<int64_t>(w) * D.RV1 * 2;
  double* c = L.cf + static_cast<int64_t>(w) * D.CW;
  double tmax = 0.0, cmem = 0.0;
  for (int j = 0; j < D.S; ++j) {
    const int row = m[M_S + j];
    const double t = rvw[row * 2];
    const double mem = rvw[row * 2 + 1] > 0.0 ? t : 0.0;
    tmax = j == 0 ? t : mx(tmax, t);
    cmem = j == 0 ? mem : mx(cmem, mem);
    c[2 + j] = t;
  }
  for (int j = 0; j < D.PS; ++j) {
    const int row = D.R + 1 + m[M_S + D.S + j];
    const double t = rvw[row * 2];
    tmax = mx(tmax, t);
    c[2 + D.S + j] = t;
  }
  c[0] = tmax;
  c[1] = cmem;
}

// one prefetch op into the inflight-slot array (reference :685-694)
SB_DEV int64_t prefetch_slot(Lane& L, const Dims& D, double lat) {
  int slot = 0;
  int64_t freet = L.pf[0];
  for (int j = 1; j < D.PF; ++j)
    if (L.pf[j] < freet) {
      freet = L.pf[j];
      slot = j;
    }
  const int64_t done = static_cast<int64_t>(static_cast<double>(mx(L.cycle, freet)) + lat);
  L.pf[slot] = done;
  return done;
}

// a fired prefetch: its counters, and its interval's registers maxed up to
// their landing time (reference :696-703, :730-736)
SB_DEV int64_t fire_prefetch(Lane& L, const Dims& D, int w, int ii) {
  const double lat = iv_lat(L, ii);
  const int64_t done = prefetch_slot(L, D, lat);
  L.cpo += 1;
  L.cpc += static_cast<int64_t>(lat);
  L.cps += done - L.cycle;
  L.cm += L.ivt[ii * 4 + 1];
  const double dt = static_cast<double>(done);
  for (int j = 0; j < D.GV; ++j) {
    const int r = L.ivregs[ii * D.GV + j];
    if (r >= 0) {
      double* p = L.rv + (static_cast<int64_t>(w) * D.RV1 + r) * 2;
      *p = mx(*p, dt);
    }
  }
  return done;
}

// Greedy lowest-wid-ready activation (reference :705-755): the lane's first
// `acap - na` READY resident warps, in wid order, each with its activation
// prefetch where the lane is cached; thread 0 walks them in order.
SB_DEV void activation(Lane& L, const Dims& D) {
  sync();
  uint64_t cand = 0;
  for (int base = 0; base < D.W; base += SB_T) {
    const int w = base + tid();
    const bool p = w < D.W && L.res[w] && L.wf[static_cast<int64_t>(w) * D.NWF + F_ST] == READY;
    cand |= static_cast<uint64_t>(ballot(p)) << base;
  }
  const int n = mn(popc(cand), mx(L.acap - L.na, 0));
  if (tid() == 0) {
    for (int i = 0; i < n; ++i) {
      const int w = ctz(cand);
      cand &= cand - 1;
      L.act[L.na + i] = w;
      int64_t* row = L.wf + static_cast<int64_t>(w) * D.NWF;
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
  }
  L.na += n;
  L.cact += n;
  sync();
}

// The first entry equal to `key` in the lane's RFC table, or -1: the
// team's threads scan strided entries, a ballot a round (uniform result).
SB_DEV int rfc_find(const Lane& L, const Dims& D, int64_t key) {
  for (int base = 0; base < D.E; base += SB_T) {
    const int e = base + tid();
    const uint32_t hit = ballot(e < D.E && L.rc[e * 2] == key);
    if (hit) return base + ctz(hit);
  }
  return -1;
}

// The _issue body for the selected warp (reference :757-944), run by the
// team: the RFC's table scans strided over the threads, everything else on
// thread 0, in the reference's order.  `happened` and `sfail` are thread 0's.
SB_DEV void issue_one(Lane& L, const Dims& D, int wsel, double cycf, bool& happened,
                      bool& sfail) {
  int64_t* row = L.wf + static_cast<int64_t>(wsel) * D.NWF;
  const int64_t pcs = row[F_PC];
  const int32_t* m = meta_row(L, D, pcs);
  const int kind = m[M_KIND];
  const bool bra = kind == OP_BRA, ext = kind == OP_EXIT, opnd = !bra && !ext;
  const bool is_ld = kind == OP_LD, is_set = kind == OP_SET;
  const int64_t nacc = m[M_NACC];
  const int m_ps = M_S + D.S, m_d = m_ps + D.PS, m_g = m_d + D.DD;
  // RFC classification against the pre-issue cache state (:769-782)
  int64_t keyv[MAX_G];
  int pos[MAX_G];
  int64_t n_miss = 0, n_hit = 0;
  if (L.rfc && opnd) {
    for (int i = 0; i < D.G; ++i) {
      const int r = m[m_g + i];
      keyv[i] = r >= 0 ? static_cast<int64_t>(wsel) * (D.R + 1) + r : -2;
      pos[i] = r >= 0 ? rfc_find(L, D, keyv[i]) : -1;   // first match (:825)
      n_miss += r >= 0 && pos[i] < 0;
      n_hit += pos[i] >= 0;
    }
  }
  const int64_t n_bw = L.bl ? (opnd ? nacc : 0) : (L.rfc ? n_miss : 0);
  bool ok = false;
  if (tid() == 0) {
    // the operand collector: first free slot (:798-802)
    int cslot = 0;
    int64_t cfree = L.col[0];
    for (int j = 1; j < D.C; ++j)
      if (L.col[j] < cfree) {
        cfree = L.col[j];
        cslot = j;
      }
    ok = opnd && cfree <= L.cycle;
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
    L.col[cslot] = ok ? L.cycle + L.brf_i : cfree;
    sfail = opnd && !ok;
    if (ok) {
      L.cm += L.bl ? nacc : (L.rfc ? n_miss : 0);
      if (L.rfc || L.fam) L.ca += nacc;
      L.ch += L.rfc ? n_hit : (L.fam ? nacc : 0);
    }
  }
  ok = bcast(static_cast<int>(ok));
  if (ok && L.rfc) {
    // LRU: move every pre-state hit to the end in operand order (:815-829)
    sync();
    int64_t hits = 0;
    for (int i = 0; i < D.G; ++i)
      if (pos[i] >= 0) {
        if (tid() == 0) {
          int64_t* stamp = L.rc + pos[i] * 2 + 1;
          *stamp = mx(*stamp, L.rstamp + hits);
        }
        ++hits;
      }
    L.rstamp += hits;
    sync();
    // then insert the misses, evicting the oldest stamp (:830-845)
    for (int i = 0; i < D.G; ++i) {
      const int64_t ki = keyv[i];
      if (ki < 0 || rfc_find(L, D, ki) >= 0) continue;
      const bool full = L.rcnt >= L.ecap;
      int slot = L.rcnt;
      if (full) {
        int64_t oldest = INT64_MAX;
        slot = D.E;
        for (int e = tid(); e < D.E; e += SB_T)
          if (L.rc[e * 2 + 1] < oldest) {
            oldest = L.rc[e * 2 + 1];
            slot = e;
          }
        team_argmin(oldest, slot);
      }
      slot = mn(slot, D.E - 1);
      sync();
      if (tid() == 0) {
        L.rc[slot * 2] = ki;
        L.rc[slot * 2 + 1] = L.rstamp;
      }
      L.rstamp += 1;
      if (!full) L.rcnt += 1;
      sync();
    }
  }
  sync();
  if (tid() != 0) return;
  const double read_lat = (L.rfc && n_miss > 0) ? L.mrfc : L.rl0;
  const double rl = cycf + read_lat;
  // memory latency: jitter hash (in uint64) and the DRAM queue (:846-858)
  const bool ldo = ok && is_ld;
  const int64_t mops = row[F_MO];
  const uint64_t hu = static_cast<uint64_t>(wsel) * 2654435761ull +
                      static_cast<uint64_t>(L.seed) * 97ull +
                      static_cast<uint64_t>(mops) * 40503ull;
  const int64_t h = static_cast<int64_t>(hu & 0xFFFFull);
  const bool hit = static_cast<double>(h) / 65535.0 < L.l1h;
  const double spread = (static_cast<double>(h >> 3) / 8191.0 - 0.5) * 0.6;
  const double dstart = mx(cycf, L.dnext);
  if (ldo && !hit) L.dnext = dstart + L.drint;
  const int64_t mlat = hit ? L.l1c
                           : static_cast<int64_t>((dstart - cycf) + L.memf * (1.0 + spread));
  // writeback chain and the dst register / predicate writes (:859-880)
  const double da = is_set ? rl + L.aluf
                           : (is_ld ? rl + (static_cast<double>(mlat) + L.wlat) : rl + L.alw);
  double* rvw = L.rv + static_cast<int64_t>(wsel) * D.RV1 * 2;
  if (ok && !is_set) {
    for (int d = 0; d < D.DD; ++d) {
      const int r = m[m_d + d];
      if (r < D.R) {
        rvw[r * 2] = da;
        rvw[r * 2 + 1] = is_ld ? 1.0 : 0.0;
      }
    }
  } else if (ok) {
    const int pd = m[M_PDST];
    if (pd < D.PRS) {
      rvw[(D.R + 1 + pd) * 2] = da;
      rvw[(D.R + 1 + pd) * 2 + 1] = 0.0;
    }
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
  if (isl) row[F_LC + lsl] = tkl ? c : 0;
  if (isd) row[f_dc + dsl] = v + 1;
  row[F_ST] = ext ? int64_t(DONE) : st_new;
  row[F_PC] = npce;
  row[F_IV] = iv_new;
  row[F_RA] = ra_new;
  row[F_IS] += happened;
  row[F_MO] = mops + ldo;
  if (happened) refresh_cf(L, D, wsel, mn(npce, static_cast<int64_t>(D.P)));
}

// One tick of one lane (reference :946-1097), the lane alive.
SB_DEV void tick(Lane& L, const Dims& D) {
  // cycle-budget watchdog (:948-952): the lane stops at this cycle
  if (L.maxc > 0 && L.cycle > L.maxc) {
    L.budget = true;
    L.alive = false;
    return;
  }
  // wake: WAIT->READY, PREFETCH->ACTIVE once ready_at arrives (:954-960)
  for (int w = tid(); w < D.W; w += SB_T) {
    int64_t* row = L.wf + static_cast<int64_t>(w) * D.NWF;
    if (L.res[w] && row[F_RA] <= L.cycle) {
      if (row[F_ST] == WAIT) row[F_ST] = READY;
      else if (row[F_ST] == PREFETCH) row[F_ST] = ACTIVE;
    }
  }
  activation(L, D);
  // issue slots over the frozen active list, round-robin ranks (:962-1005)
  const int na = L.na;
  const int64_t nz = mx(na, 1);
  const int64_t rot = pymod(L.cycle, nz);
  const double cycf = static_cast<double>(L.cycle);
  const double thr = static_cast<double>(L.cycle + L.thr);
  int wida[PER_T];
  int64_t rank[PER_T];
  bool ndacc[PER_T];
  double msacc[PER_T];
  for (int i = 0; i < PER_T; ++i) {
    const int a = i * SB_T + tid();
    const bool posv = a < na;
    wida[i] = posv ? L.act[a] : 0;
    rank[i] = posv ? pymod(a - rot, nz) : BIG;
    ndacc[i] = false;
    msacc[i] = 0.0;
  }
  bool issue_any = false, strct = false;
  for (int j = 0; j < D.IW; ++j) {
    const bool slot_on = j < L.iw;
    int64_t best = BIG;
    int besta = MAX_W;
    bool isact[PER_T], atend[PER_T], ready[PER_T];
    double blocked[PER_T];
    for (int i = 0; i < PER_T; ++i) {
      const int a = i * SB_T + tid();
      const bool posv = a < na;
      const int64_t* row = L.wf + static_cast<int64_t>(wida[i]) * D.NWF;
      const double* cfa = L.cf + static_cast<int64_t>(wida[i]) * D.CW;
      isact[i] = posv && row[F_ST] == ACTIVE;
      atend[i] = posv && row[F_PC] >= L.endpc;
      ready[i] = isact[i] && !atend[i] && cfa[0] <= cycf;
      blocked[i] = posv ? cfa[1] : 0.0;
      const int64_t rrk = ready[i] && slot_on ? rank[i] : BIG;
      if (rrk < best) {
        best = rrk;
        besta = a;
      }
    }
    team_argmin(best, besta);
    const bool picked = best < BIG && slot_on;
    for (int i = 0; i < PER_T; ++i) {
      const bool visited = slot_on && rank[i] <= best;   // rank BIG: not on the list
      ndacc[i] = ndacc[i] || (visited && isact[i] && atend[i]);
      // blocked on long memory: a deactivation candidate (:991-1001)
      if (L.cached && visited && isact[i] && !atend[i] && !ready[i] && blocked[i] > thr)
        msacc[i] = mx(msacc[i], blocked[i]);
    }
    if (picked) {
      bool h = false, sf = false;
      sync();
      issue_one(L, D, L.act[besta], cycf, h, sf);
      issue_any = issue_any || bcast(static_cast<int>(h));
      strct = strct || bcast(static_cast<int>(sf));
      sync();
    }
  }
  // deferred DONE marks (:1006-1008)
  for (int i = 0; i < PER_T; ++i)
    if (ndacc[i]) L.wf[static_cast<int64_t>(wida[i]) * D.NWF + F_ST] = DONE;
  // two-level deactivation of the stalled warps (:1009-1022)
  if (L.cached) {
    int64_t nwb = 0;
    for (int i = 0; i < PER_T; ++i) {
      int64_t* row = L.wf + static_cast<int64_t>(wida[i]) * D.NWF;
      if (msacc[i] > 0.0 && row[F_ST] == ACTIVE) {
        const int ii = row[F_IV] >= 0 ? static_cast<int>(row[F_IV]) : D.IVS;
        nwb += L.ivt[ii * 4 + 2];
        row[F_ST] = WAIT;
        row[F_RA] = static_cast<int64_t>(msacc[i]);
        row[F_IV] = -1;
      }
    }
    nwb = team_sum(nwb);
    L.cwb += nwb;
    L.cm += nwb;
  }
  // compact the active list, retire DONE warps, admit pending ones (:1023-1045)
  uint64_t keep = 0, donem = 0;
  for (int i = 0; i < PER_T; ++i) {
    const int a = i * SB_T + tid();
    const bool posv = a < na;
    const int64_t st = posv ? L.wf[static_cast<int64_t>(wida[i]) * D.NWF + F_ST]
                            : int64_t(ACTIVE);
    keep |= static_cast<uint64_t>(ballot(posv && st != WAIT && st != DONE)) << (i * SB_T);
    donem |= static_cast<uint64_t>(ballot(posv && st == DONE)) << (i * SB_T);
  }
  sync();
  const int newna = popc(keep);
  for (int i = 0; i < PER_T; ++i) {
    const int a = i * SB_T + tid();
    if ((keep >> a) & 1ull) L.act[popc(keep & ((uint64_t(1) << a) - 1))] = wida[i];
    if ((donem >> a) & 1ull) L.res[wida[i]] = 0;
  }
  for (int p = tid(); p < D.A; p += SB_T)
    if (p >= newna) L.act[p] = 0;
  L.na = newna;
  L.nr -= popc(donem);
  const int nadm = mx(mn(L.nw - L.ptr, L.rcap - L.nr), 0);
  for (int w = tid(); w < D.W; w += SB_T)
    if (w >= L.ptr && w < L.ptr + nadm) L.res[w] = 1;
  L.nr += nadm;
  L.ptr += nadm;
  activation(L, D);
  // terminate a finished lane (:1050-1053)
  if (L.nr == 0 && L.ptr >= L.nw) {
    L.alive = false;
    return;
  }
  // classify the zero-issue cycle, find the next event (:1054-1092)
  bool saw_pf = false, saw_mem = false, saw_dep = false;
  double c2 = INFINITY, tsp = INFINITY;
  for (int w = tid(); w < D.W; w += SB_T) {
    const int64_t* row = L.wf + static_cast<int64_t>(w) * D.NWF;
    const double* cfw = L.cf + static_cast<int64_t>(w) * D.CW;
    const int64_t st = row[F_ST];
    saw_pf = saw_pf || st == PREFETCH;
    if (st == ACTIVE && row[F_PC] < L.endpc) {
      saw_mem = saw_mem || cfw[1] > cycf;
      saw_dep = saw_dep || cfw[0] > cycf;
      for (int j = 2; j < D.CW; ++j)
        if (cfw[j] > cycf) tsp = mn(tsp, cfw[j]);
    }
    if (L.res[w] && (st == WAIT || st == PREFETCH)) c2 = mn(c2, static_cast<double>(row[F_RA]));
  }
  int64_t colf = INT64_MAX;
  for (int j = tid(); j < D.C; j += SB_T) colf = mn(colf, L.col[j]);
  saw_pf = team_any(saw_pf);
  saw_mem = team_any(saw_mem);
  saw_dep = team_any(saw_dep);
  c2 = team_min(c2);
  tsp = team_min(tsp);
  colf = team_min(colf);
  const bool drain = L.ptr >= L.nw && L.nr < L.tcap;
  const int cat = drain ? CAT_DRAIN : strct ? CAT_BANK : saw_pf ? CAT_PREFETCH
                : saw_mem ? CAT_MEM : saw_dep ? CAT_ALU_DEP : CAT_IDLE;
  const double c1 = mn(colf > L.cycle ? static_cast<double>(colf) : INFINITY, c2);
  const double best = mn(c1, tsp);
  const int64_t cyc1 = L.cycle + 1;
  const int64_t nxt = best == INFINITY ? cyc1 : mx(static_cast<int64_t>(best), cyc1);
  const int64_t delta = issue_any ? 1 : nxt - L.cycle;
  L.bd[issue_any ? CAT_ISSUE : cat] += delta;
  L.cycle += delta;
  sync();
}

template <class X> SB_DEV X* plane(const Args& a, Plane p, int k) {
  return static_cast<X*>(a.planes[p]) + a.lane_stride[p] * k;
}

// Lane k, every tick to completion; returns its tick count.
SB_DEV int64_t run_lane(const Args& a, int k) {
  Dims D;
  D.W = a.dims[D_W]; D.NWF = a.dims[D_NWF]; D.A = a.dims[D_A]; D.E = a.dims[D_E];
  D.P = a.dims[D_P]; D.S = a.dims[D_S]; D.PS = a.dims[D_PS]; D.DD = a.dims[D_DD];
  D.G = a.dims[D_G]; D.R = a.dims[D_R]; D.PRS = a.dims[D_PRS]; D.LS = a.dims[D_LS];
  D.IVS = a.dims[D_IVS]; D.IW = a.dims[D_IW]; D.PF = a.dims[D_PF]; D.C = a.dims[D_C];
  D.GV = a.dims[D_GV]; D.MW = a.dims[D_MW]; D.CW = a.dims[D_CW]; D.RV1 = a.dims[D_RV1];
  Lane L;
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
  L.meta = plane<const int32_t>(a, PL_meta, k);
  L.ivt = plane<const int32_t>(a, PL_ivt, k);
  L.ivregs = plane<const int32_t>(a, PL_ivregs, k);
  L.wf = plane<int64_t>(a, PL_wf, k);
  L.cf = plane<double>(a, PL_cf, k);
  L.rv = plane<double>(a, PL_rv, k);
  L.act = plane<int32_t>(a, PL_act, k);
  L.res = plane<uint8_t>(a, PL_res, k);
  L.pf = plane<int64_t>(a, PL_pf, k);
  L.col = plane<int64_t>(a, PL_col, k);
  L.rc = plane<int64_t>(a, PL_rc, k);
  int64_t* bd = plane<int64_t>(a, PL_bd, k);
  for (int c = 0; c < NCAT; ++c) L.bd[c] = bd[c];
  const int64_t tmax = *plane<const int64_t>(a, PL_tmax, k);
  int64_t ticks = 0;
  while (L.alive && ticks <= tmax) {
    ++ticks;
    tick(L, D);
  }
  sync();
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
    for (int c = 0; c < NCAT; ++c) bd[c] = L.bd[c];
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
         d[D_RVW] == d[D_R] + 1 + d[D_PRS] + 1;
}

#if defined(__CUDACC__)
__global__ void __launch_bounds__(32) sim_batch_kernel(const Args a) {
  const int64_t ticks = run_lane(a, blockIdx.x);
  if (threadIdx.x == 0 && ticks > 0)
    atomicMax(static_cast<unsigned long long*>(a.planes[PL_guard]),
              static_cast<unsigned long long>(ticks));
}
#endif

}  // namespace

extern "C" const char* sim_batch_layout() { return kLayout; }

#if defined(__CUDACC__)
// One launch runs the whole chunk: K CTAs of one warp.  `guard` must hold 0.
extern "C" int sim_batch_launch(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (!takes(a)) return cudaErrorInvalidValue;
  sim_batch_kernel<<<a.dims[D_K], 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
#else
// The same run on the host, lane after lane (a C++ compiler without CUDA).
extern "C" int sim_batch_run_host(const void* args) {
  const Args& a = *static_cast<const Args*>(args);
  if (!takes(a)) return 1;
  int64_t* guard = static_cast<int64_t*>(a.planes[PL_guard]);
  for (int k = 0; k < a.dims[D_K]; ++k) *guard = std::max(*guard, run_lane(a, k));
  return 0;
}
#endif
