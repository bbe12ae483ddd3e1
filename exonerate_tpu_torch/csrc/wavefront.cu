// Exhaustive anti-diagonal Viterbi for a batch of pairs: K1 (score and
// region modes), K4 (path mode) and K2 (the cluster wavefront, every
// mode), hand-written for Hopper (sm_90a).
//
// Built once per model plan (_cudabuild.load(stem, header), with
// COMPILED_PLAN): plan.h, generated by engine/plan_cuda.py, holds the plan
// table below as constexpr data, and both kernels, plan_kernel (K1/K4)
// and ring_kernel (K2, K3 on a cluster, K4 on a cluster), run one cell
// body (run_cell) that unrolls it.
//
// Replaces exonerate_tpu/engine/pallas_wavefront.py: the Pallas kernel
// built by build_pallas_wavefront (:427; body `kernel` :593 and
// `_one_diagonal` :722), in modes score/region, and its path mode
// (:1147-1150), which also writes each state's winning plan id per cell.
//
// What it computes.  K1/K4: one CTA per pair.  The CTA loops over all
// qlen+tlen+1 anti-diagonals d = i + j; its threads own the cells of a
// diagonal at i = lo + tid + k*blockDim, and one __syncthreads() per
// diagonal orders the writes of diagonal d before the reads of d+1.  Per
// cell, the plan table (one int32 row per transition of _build_plan, in
// model order; engine/wavefront.py defines the columns) is applied row
// by row: source cell, calc, shadow check, clamps, then a strictly
// greater replacement of the output state's value.  This is the calc
// vocabulary of c4_viterbi (exonerate_tpu/sdplib.cpp:919) with the
// guarded semantics of the Pallas body (:832-1040):
//  - a tvec calc reads the SOURCE column sj = d - i - at (tslice, :779-800);
//  - the intron shadow check gets the SOURCE position si+qstart / sj+tstart
//    (:969-970); the window is pos - lane + 2 against [min, max]
//    (model/intron.py:140-149);
//  - start lanes take source coordinates (:997-1002), and a transition
//    from START sets the region start to (si, sj) (:1003-1008);
//  - replacement is strict val > cur in plan order (:1026); end cells
//    register with the lexicographic key (score desc, j asc, i asc)
//    (:1061-1091, reduced once in _emit :692-720), never with an
//    atomicMax on the score alone;
//  - a pair with no alignment reports NEG, 0, 0 (:707-710);
//  - scores are int32 and wrap like the reference, so base + calc is
//    added as uint32 (signed overflow is undefined in C++); the clamps to
//    NEG and IMPOSSIBLY_HIGH_SCORE follow :976-987.
// A row whose source is invalid or dead (base <= NEG) cannot beat the
// NEG the output starts from, so the kernel skips it: the same result
// as the masked evaluation of the Pallas body.
//
// Kernel K3, the SubOpt mask of Waterman-Eggert re-runs (the `_blocked`
// input of build_pallas_wavefront: _skew_blocked :1129, applied at
// :909-910 and :991-992), is the MASKED instantiation: each cell reads
// its bit of the packed (B, Qp+1, ceil((Tp+1)/8)) plane once, addressed
// by the destination cell in np.packbits order, and a plan row flagged
// F_MATCH is skipped at a blocked cell like a dead source.  The TPU's
// skewed (D, B, QV) int32 plane is a lane layout and is not copied; the
// reads here are strided by the plane's row across the threads of a
// diagonal (one sector per thread per cell; ring_kernel keeps each row's
// byte and reloads it once per 8 cells).  A masked batch whose clusters
// all fit the card at once runs on K2 (cuda_wavefront.on_cluster), so a
// Waterman-Eggert re-run of one long pair spans C SMs, not one.
//
// What bounds K1/K4 on the H100.  Not arithmetic: the carry ring and
// one cell's chain of dependent work.  A (K+1)-diagonal ring of every
// state read across diagonals, plus the live shadow/region lanes, is
// about 0.5 MB per 2175^2 pair, far over the 227 KB of shared memory a
// block may hold, so it lives in global memory and stays resident in the
// 50 MB L2 (B=64 is ~32 MB).  Every cell reads its source rows from L2
// and writes its own, and every diagonal ends in a block-wide barrier.
// With the plan compiled in, a cell's ring loads have constant offsets
// and issue together, its state is registers, and no plan row is read or
// decoded at run time; the threads per CTA follow the register budget
// (plan_threads), only states that a later diagonal reads get ring rows,
// and only live (state, lane) slots are stored (_storage_plan).  64 CTAs
// fill 64 of the 132 SMs.
//
// Kernel K2, the streamed wavefront (build_pallas_wavefront(...,
// stream=True), :438, window DMAs :607-640), runs the same cells on a
// thread-block cluster.  The TPU streams the reversed target vectors
// from HBM through a per-diagonal VMEM window because a chromosome-scale
// target does not fit VMEM; here K1 already reads its target vectors from
// global memory, so what a chromosome-scale pair at B=1 lacks is SMs, not
// memory: one CTA walks ~1.2 M diagonals of ~9 cells per thread.  K2 runs
// each pair on a cluster of C CTAs, one row per thread at Qp 2304, with a
// cluster barrier per diagonal: ring_kernel.  Its rows stay with their
// threads for the whole launch.  Where the pair's carry ring fits a
// CTA's shared memory (cuda_wavefront.ring_in_smem: est2genome in every
// mode, protein2genome and coding2genome in score and path modes) each
// CTA keeps its own rows' ring in shared memory, and the K rows below a
// CTA's first come from its neighbour through distributed shared memory,
// once per diagonal; elsewhere (its SMEM_RING flag false) the ring is in
// global memory, as in K1.
//
// What bounds ring_kernel with the shared ring: one cell's chain of
// dependent work per thread per diagonal, with 8 warps on each of the C
// SMs to hide it (the calcs' loads of the query and target vectors from
// global memory, the ring's loads from shared memory), over a floor of
// the cluster barrier, the halo copy and the ring writes.  The plan is
// compiled in as for K1/K4: the cell's state is registers, and shared
// memory holds only the ring with its halo, the mask bytes and the
// block reduce.
//
// The checkpointed traceback (find_path_checkpointed,
// exonerate_tpu/engine/wavefront.py:700: an XLA route over diagonal
// segments, the reference's --dpmemory bound) also runs on the cluster
// kernel: a launch may run a span [d_begin, d_end) of the
// diagonals, continuing the carry ring that the launch before it left,
// and in path mode it writes only that span's traceback planes (K4 on a
// cluster).  A pair whose cube does not fit the card (a path across a
// chromosome-scale target) is walked back one segment at a time.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>
#include <utility>

#include "plan.h"   // struct WavePlan: the model's plan (plan_cuda.py)

namespace cg = cooperative_groups;

namespace {

constexpr int32_t NEG = -987654321;       // IMPOSSIBLY_LOW_SCORE
constexpr int32_t HIGH = 987654321;       // IMPOSSIBLY_HIGH_SCORE
constexpr int THREADS = 256;              // a power of two (final reduce)
constexpr int MAX_L = 6;                  // lanes per state (cuda_wavefront)
constexpr int LEAN_L = 4;                 // ... of a plan that is not FULL
constexpr int MAX_CLUSTER = 16;           // K2: CTAs per pair, non-portable
constexpr int PORTABLE_CLUSTER = 8;       // ... without that attribute
constexpr size_t MAX_SMEM = 232448;       // dynamic shared memory of a CTA
constexpr int RING_LOAD = 1;              // Params::ring_io bits (SMEM_RING)
constexpr int RING_STORE = 2;
constexpr int HALO_LOADS = 4;             // DSMEM loads in flight per lane

// plan-table columns (engine/wavefront.py: P_*)
constexpr int P_AQ = 0;
constexpr int P_AT = 1;
constexpr int P_IN = 2;
constexpr int P_OUT = 3;
constexpr int P_FLAGS = 4;
constexpr int P_CALC = 5;
constexpr int P_C0 = 6;
constexpr int P_C1 = 7;
constexpr int P_C2 = 8;
constexpr int P_C3 = 9;
constexpr int P_C4 = 10;
constexpr int P_SH_LANE_Q = 11;
constexpr int P_SH_LANE_T = 12;
constexpr int P_SH_MIN = 13;
constexpr int P_SH_MAX = 14;
constexpr int P_C5 = 15;
constexpr int P_C6 = 16;
constexpr int P_NSTART = 17;
constexpr int P_ST_DES0 = 18;     // start lane k: P_ST_DES0 + 2k ...
constexpr int P_ST_SRC0 = 19;     // ... and its source, P_ST_SRC0 + 2k
constexpr int PLAN_COLS = 28;

// P_ST_SRC codes: the source cell's target or query position, or
// ST_TVEC + r: tvecs row r at the source column (a shadow start vector)
constexpr int ST_TARGET = 0;
constexpr int ST_QUERY = 1;
constexpr int ST_TVEC = 2;

// P_FLAGS bits
constexpr int F_FROM_START = 1;
constexpr int F_TO_END = 2;
constexpr int F_P_UNDER = 4;
constexpr int F_P_OVER = 8;
constexpr int F_SH_Q = 16;
constexpr int F_SH_T = 32;
constexpr int F_MATCH = 64;

// P_CALC kinds
constexpr int C_NONE = 0;
constexpr int C_SCALAR = 1;
constexpr int C_QVEC = 2;
constexpr int C_TVEC = 3;
constexpr int C_FACTORED = 4;
constexpr int C_SPLIT = 5;

// scope codes
constexpr int SCOPE_ANYWHERE = 0;
constexpr int SCOPE_EDGE = 1;
constexpr int SCOPE_QUERY = 2;
constexpr int SCOPE_TARGET = 3;
constexpr int SCOPE_CORNER = 4;

constexpr int MODE_SCORE = 0;
constexpr int MODE_REGION = 1;
constexpr int MODE_PATH = 2;

// The per-pair arguments of a launch (the plan, its storage map and the
// model numbers are WavePlan's)
struct Params {
    const int32_t* dims;        // (B, 4): qstart, tstart, qlen, tlen
    const int32_t* qvecs;       // (B, nq, Qp+1)
    const int32_t* tvecs;       // (B, nt, Tp+1)
    const int32_t* tables;      // (B, ntab)
    const int32_t* scalars;     // (B, nsc)
    int32_t* ring;              // (B, R, NR, Qp+1)
    int32_t* lring;             // (B, R, NL, Qp+1)
    uint8_t* tb;                // path mode: (B, D, S, Qp+1), D below
    const uint8_t* blocked;     // (B, Qp+1, ceil((Tp+1)/8)), MASKED
    int32_t* out;               // (5, B)
    int nq, nt, ntab, nsc;
    int B, Qp, Tp, start_scope, end_scope;
    // ring_kernel only: the diagonals [d_begin, d_end) of this launch, which
    // continues the carry ring a launch over [0, d_begin) left (a segment
    // of the checkpointed traceback); tb then holds D = d_end - d_begin
    // diagonals, diagonal d at d - d_begin (plan_kernel: D = Qp + Tp + 1)
    int d_begin, d_end;
    // ring_kernel only: rows per thread (a CTA owns k * THREADS rows), and
    // with SMEM_RING whether the launch loads its first diagonal's carry
    // from (ring, lring) (RING_LOAD) and stores its last diagonals' back
    // (RING_STORE)
    int k, ring_io;
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ bool start_ok(int scope, int si, int sj) {
    switch (scope) {
        case SCOPE_ANYWHERE: return true;
        case SCOPE_EDGE: return si == 0 || sj == 0;
        case SCOPE_QUERY: return si == 0;
        case SCOPE_TARGET: return sj == 0;
        case SCOPE_CORNER: return si == 0 && sj == 0;
        default: return false;
    }
}

__device__ __forceinline__ bool end_ok(int scope, int i, int j, int qlen,
                                       int tlen) {
    switch (scope) {
        case SCOPE_ANYWHERE: return true;
        case SCOPE_EDGE: return i == qlen || j == tlen;
        case SCOPE_QUERY: return i == qlen;
        case SCOPE_TARGET: return j == tlen;
        case SCOPE_CORNER: return i == qlen && j == tlen;
        default: return false;
    }
}

// (score desc, j asc, i asc)
__device__ __forceinline__ bool better(int32_t s, int32_t j, int32_t i,
                                       int32_t bs, int32_t bj, int32_t bi) {
    return s > bs || (s == bs && (j < bj || (j == bj && i < bi)));
}

// floor division by 6, as jnp's // on int32
__device__ __forceinline__ int floordiv6(int32_t x) {
    const int q = x / 6;
    return (x % 6 != 0 && x < 0) ? q - 1 : q;
}

// The model's plan, compiled in (WavePlan, engine/plan_cuda.py).  Every
// loop over plan rows, states and lanes is unrolled in plan order at
// compile time, so each row's source state, output state, calc kind, ring
// row and lane rows are constants: the cell's S scores, S*L lanes and S
// plan ids are registers, the calc kind's switch and the ring and lane
// maps fold away, and a ring source slot is (d - adv) % R with adv and R
// constants.
using IP = WavePlan;

// a compile-time int: a loop index of `each`, usable as an array index
// in device code (std::integral_constant's conversion is host-only)
template <int V>
struct IC {
    static constexpr int value = V;
    __host__ __device__ constexpr operator int() const { return V; }
};

// f(IC<B>), f(IC<B + 1>), ..., f(IC<E - 1>), in that order
template <int B, typename F, int... I>
__device__ __forceinline__ void each_from(F& f,
                                          std::integer_sequence<int, I...>) {
    (f(IC<B + I>{}), ...);
}

template <int B, int E, typename F>
__device__ __forceinline__ void each(F&& f) {
    each_from<B>(f, std::make_integer_sequence<int, (E > B ? E - B : 0)>{});
}

// FULL: the plan holds kernel K9's pieces (a C_SPLIT row, or a start lane
// read from a tvec) or more than LEAN_L lanes per state; plan_cuda
// derives it from the same table
constexpr bool plan_is_full() {
    if (IP::L > LEAN_L) return true;
    for (int r = 0; r < IP::N_PLAN; ++r) {
        if (IP::plan(r, P_CALC) == C_SPLIT) return true;
        for (int k = 0; k < IP::plan(r, P_NSTART); ++k)
            if (IP::plan(r, P_ST_SRC0 + 2 * k) >= ST_TVEC) return true;
    }
    return false;
}
static_assert(IP::FULL == plan_is_full(), "the header's FULL is its plan's");
static_assert(IP::L <= MAX_L, "lanes per state");

// Threads per CTA of plan_kernel: as many as the register file (65,536 a
// SM) holds at this plan's per-thread cell state, S scores, S*L lanes and
// in path mode S plan ids, beside ~40 registers of addressing and loop
// state.  A pair is one CTA, so more threads are fewer cells in series
// per thread on a diagonal (ceil(rows / threads)).  ring_kernel takes
// THREADS, at most 255 registers a thread.
constexpr int plan_threads() {
    return IP::S * (1 + IP::L) + (IP::MODE == MODE_PATH ? IP::S : 0) + 40
                   <= 64 ? 1024
        : IP::S * (1 + IP::L) + (IP::MODE == MODE_PATH ? IP::S : 0) + 40
                   <= 128 ? 512
        : 256;
}
static constexpr int PT = plan_threads();

// One pair's inputs, as a cell reads them
struct Pair {
    const int32_t* qv;
    const int32_t* tv;
    const int32_t* tab;
    const int32_t* scl;
    int W, WT;
    int32_t qstart, tstart, qlen, tlen;
    int start_scope, end_scope;
};

__device__ __forceinline__ Pair pair_of(const Params& p, int b) {
    Pair c;
    c.W = p.Qp + 1;
    c.WT = p.Tp + 1;
    c.qstart = p.dims[b * 4 + 0];
    c.tstart = p.dims[b * 4 + 1];
    c.qlen = p.dims[b * 4 + 2];
    c.tlen = p.dims[b * 4 + 3];
    c.qv = p.qvecs + (size_t)b * p.nq * c.W;
    c.tv = p.tvecs + (size_t)b * p.nt * c.WT;
    c.tab = p.tables + (size_t)b * p.ntab;
    c.scl = p.scalars + (size_t)b * p.nsc;
    c.start_scope = p.start_scope;
    c.end_scope = p.end_scope;
    return c;
}

// A thread's best end cell so far, by the lexicographic key, and its
// region start
struct Best {
    int32_t s = NEG, j = INT32_MAX, i = INT32_MAX, qs = 0, ts = 0;
};

// The carry ring in global memory: one pair's (R, NR, W) score rows and
// (R, NL, W) lane rows.  plan_kernel reads its own CTA's writes (L2 false);
// ring_kernel without SMEM_RING reads past L1 (L2 true), as the other
// CTAs of the cluster write it.
template <bool L2>
struct GlobalRing {
    int32_t* ring;
    int32_t* lring;
    int W;
    __device__ __forceinline__ int32_t score(int sl, int rr, int i) const {
        const int32_t* a = ring + ((size_t)sl * IP::NR + rr) * W + i;
        if constexpr (L2) return __ldcg(a);
        else return *a;
    }
    __device__ __forceinline__ int32_t lane(int sl, int lr, int i) const {
        const int32_t* a = lring + ((size_t)sl * IP::NL + lr) * W + i;
        if constexpr (L2) return __ldcg(a);
        else return *a;
    }
    __device__ __forceinline__ void put_score(int sl, int rr, int i,
                                              int32_t x) const {
        ring[((size_t)sl * IP::NR + rr) * W + i] = x;
    }
    __device__ __forceinline__ void put_lane(int sl, int lr, int i,
                                             int32_t x) const {
        lring[((size_t)sl * IP::NL + lr) * W + i] = x;
    }
};

// ring_kernel's SMEM_RING: the CTA's R slots of its rows' NR + NL ring
// rows in shared memory, laid out [slot][ring row][H + local row] (WB =
// the CTA's rows + H wide) so that neighbouring threads hit neighbouring
// banks, the H = R - 1 halo rows below its first row included; row i at
// H + i - row0 (at0 = H - row0), lane row lr at ring row NR + lr.
struct SharedRing {
    int32_t* s;
    int at0, WB;
    __device__ __forceinline__ int32_t& at(int sl, int k, int i) const {
        return s[(sl * (IP::NR + IP::NL) + k) * WB + at0 + i];
    }
    __device__ __forceinline__ int32_t score(int sl, int rr, int i) const {
        return at(sl, rr, i);
    }
    __device__ __forceinline__ int32_t lane(int sl, int lr, int i) const {
        return at(sl, IP::NR + lr, i);
    }
    __device__ __forceinline__ void put_score(int sl, int rr, int i,
                                              int32_t x) const {
        at(sl, rr, i) = x;
    }
    __device__ __forceinline__ void put_lane(int sl, int lr, int i,
                                             int32_t x) const {
        at(sl, IP::NR + lr, i) = x;
    }
};

// The cell (i, j = d - i) of both kernels: the plan's rows in plan order
// over the cell's state in registers, then its column of the new
// diagonal (its ring rows at `slot`, in path mode its plan ids into tb_d,
// the diagonal's (S, W) planes) and its end-cell candidate.  `rg` reads
// the source rows of the ring and takes the new ones; `blk`: the cell is
// masked (MASKED, K3).  The row semantics are those of the plain version:
// source, mask, scope, calc, intron window, clamps, strict > replacement,
// start lanes.
template <bool MASKED, typename Ring>
__device__ __forceinline__ void run_cell(const Pair& c, const Ring& rg,
                                         int i, int j, int slot, bool blk,
                                         uint8_t* tb_d, Best& best) {
    constexpr int MODE = IP::MODE, S = IP::S, L = IP::L;
    constexpr int LL = L > 0 ? L : 1;
    constexpr int R = IP::R;
    constexpr int RS_Q = IP::N_SHADOW, RS_T = IP::N_SHADOW + 1;
    const int W = c.W, WT = c.WT;
    const int32_t* qv = c.qv;
    const int32_t* tv = c.tv;
    const int32_t* scl = c.scl;
    int32_t sc[S];
    int32_t ln[S][LL];
    int32_t tb[S];
    each<0, S>([&](auto s) {
        sc[s] = NEG;
        tb[s] = 0;
        each<0, LL>([&](auto l) { ln[s][l] = 0; });
    });
    each<0, IP::N_PLAN>([&](auto rc) {
        constexpr int r = decltype(rc)::value;
        constexpr int aq = IP::plan(r, P_AQ), at = IP::plan(r, P_AT);
        constexpr int in = IP::plan(r, P_IN);
        constexpr int out = IP::plan(r, P_OUT);
        constexpr int flags = IP::plan(r, P_FLAGS);
        constexpr int kind = IP::plan(r, P_CALC);
        constexpr int adv = aq + at;
        constexpr bool from_start = (flags & F_FROM_START) != 0;
        const int si = i - aq, sj = j - at;
        if (si < 0 || sj < 0) return;
        if constexpr (MASKED && (flags & F_MATCH) != 0) {
            if (blk) return;
        }
        // source: START (0), this diagonal (silent), or the ring at slot
        // (d - adv) % R, adv <= K < R
        const int src_slot = slot >= adv ? slot - adv : slot - adv + R;
        int32_t base;
        if constexpr (from_start) {
            if (!start_ok(c.start_scope, si, sj)) return;
            base = 0;
        } else {
            if constexpr (adv == 0) {
                base = sc[in];
            } else {
                constexpr int rr = IP::ring_row(in);
                static_assert(rr >= 0, "a ring source has a row");
                base = rg.score(src_slot, rr, si);
            }
            if (base <= NEG) return;
        }
        if constexpr ((flags & F_TO_END) != 0) {
            if (!end_ok(c.end_scope, i, j, c.qlen, c.tlen)) return;
        }
        // lane l of the source cell
        auto src_lane = [&](auto lc) -> int32_t {
            constexpr int l = decltype(lc)::value;
            if constexpr (from_start) {
                return 0;
            } else if constexpr (adv == 0) {
                return ln[in][l];
            } else {
                constexpr int lr = IP::lane_row(in, l);
                if constexpr (lr < 0)
                    return 0;
                else
                    return rg.lane(src_slot, lr, si);
            }
        };
        constexpr int c0 = IP::plan(r, P_C0), c1 = IP::plan(r, P_C1);
        constexpr int c2 = IP::plan(r, P_C2), c3 = IP::plan(r, P_C3);
        constexpr int c4 = IP::plan(r, P_C4);
        int32_t calc = 0;
        if constexpr (kind == C_SCALAR) {
            calc = scl[c0];
        } else if constexpr (kind == C_QVEC) {
            calc = qv[c0 * W + i];
        } else if constexpr (kind == C_TVEC) {
            calc = tv[c0 * WT + sj];
        } else if constexpr (kind == C_FACTORED) {
            const int32_t ov = qv[c4 * W + i];
            calc = ov != 0 ? ov
                : c.tab[c2 + qv[c0 * W + i] * c3 + tv[c1 * WT + sj]];
        } else if constexpr (kind == C_SPLIT) {
            // Kernel K9, the split-codon score (model/phase.py:305-327,
            // _make_split_pallas_fn).  The amino acid of a codon split by
            // an intron is decoded from packed 5-bit fields: phase 1
            // (C2) selects one of three target rows E1p0..2 (C1..C1+2) at
            // the source column by the "split c1" lane (C4) // 6, phase 2
            // one of the lanes "split p2k0..2" (C4..C6) by the N4 row
            // (C1) at the source column // 6; the field is the selector %
            // 6.  The aa then indexes the 25 query rows R0..R24 (C0..C0 +
            // 24, already shifted by aq on the host) directly.  aa 25..31
            // scores 0; a cell whose "target intron" lane (C3, the
            // intron's absolute start) is below the phase scores NEG.
            if (!(src_lane(IC<c3>{}) >= c2)) {
                calc = NEG;
            } else {
                int32_t sel, sub = 0;
                if constexpr (c2 == 1) {
                    sel = src_lane(IC<c4>{});
                    const int k = floordiv6(sel);
                    if (k >= 0 && k < 3) sub = tv[(c1 + k) * WT + sj];
                } else {
                    sel = tv[c1 * WT + sj];
                    const int k = floordiv6(sel);
                    if (k == 0)
                        sub = src_lane(IC<c4>{});
                    else if (k == 1)
                        sub = src_lane(IC<IP::plan(r, P_C5)>{});
                    else if (k == 2)
                        sub = src_lane(IC<IP::plan(r, P_C6)>{});
                }
                int field = sel % 6;
                if (field < 0) field += 6;
                const int aa = (sub >> (5 * field)) & 31;
                calc = aa < 25 ? qv[(c0 + aa) * W + i] : 0;
            }
        }
        if constexpr ((flags & (F_SH_Q | F_SH_T)) != 0) {
            const int32_t mn = scl[IP::plan(r, P_SH_MIN)];
            const int32_t mx = scl[IP::plan(r, P_SH_MAX)];
            bool bad = false;
            if constexpr ((flags & F_SH_Q) != 0) {
                const int32_t len = wadd(wsub(si + c.qstart,
                    src_lane(IC<IP::plan(r, P_SH_LANE_Q)>{})), 2);
                bad = bad || len < mn || len > mx;
            }
            if constexpr ((flags & F_SH_T) != 0) {
                const int32_t len = wadd(wsub(sj + c.tstart,
                    src_lane(IC<IP::plan(r, P_SH_LANE_T)>{})), 2);
                bad = bad || len < mn || len > mx;
            }
            if (bad) calc = NEG;
        }
        int32_t val = wadd(base, calc);
        if constexpr ((flags & F_P_UNDER) != 0) {
            if (val < NEG) val = NEG;
        }
        if constexpr ((flags & F_P_OVER) != 0) {
            if (val > HIGH) val = HIGH;
        }
        if (val < NEG) val = NEG;
        if (!(val > sc[out])) return;    // first max wins
        sc[out] = val;
        if constexpr (MODE == MODE_PATH) tb[out] = r + 1;
        if constexpr (L > 0) {
            int32_t nl[LL];
            each<0, L>([&](auto l) { nl[l] = src_lane(l); });
            each<0, IP::plan(r, P_NSTART)>([&](auto kc) {
                constexpr int k = decltype(kc)::value;
                constexpr int des = IP::plan(r, P_ST_DES0 + 2 * k);
                constexpr int src = IP::plan(r, P_ST_SRC0 + 2 * k);
                if constexpr (src == ST_TARGET)
                    nl[des] = sj + c.tstart;
                else if constexpr (src == ST_QUERY)
                    nl[des] = si + c.qstart;
                else
                    nl[des] = tv[(src - ST_TVEC) * WT + sj];
            });
            if constexpr (MODE == MODE_REGION && from_start) {
                nl[RS_Q] = si;
                nl[RS_T] = sj;
            }
            each<0, L>([&](auto l) { ln[out][l] = nl[l]; });
        }
    });
    // this cell's column of the new diagonal
    each<0, S>([&](auto sc_) {
        constexpr int s = decltype(sc_)::value;
        constexpr int rr = IP::ring_row(s);
        if constexpr (rr >= 0) rg.put_score(slot, rr, i, sc[s]);
        each<0, L>([&](auto lc) {
            constexpr int lr = IP::lane_row(s, decltype(lc)::value);
            if constexpr (lr >= 0) rg.put_lane(slot, lr, i, ln[s][lc]);
        });
        if constexpr (MODE == MODE_PATH)
            tb_d[(size_t)s * W + i] = (uint8_t)tb[s];
    });
    const int32_t es = sc[IP::END_ID];
    if (es > NEG && better(es, j, i, best.s, best.j, best.i)) {
        best.s = es;
        best.j = j;
        best.i = i;
        if constexpr (MODE == MODE_REGION) {
            best.qs = ln[IP::END_ID][RS_Q];
            best.ts = ln[IP::END_ID][RS_T];
        }
    }
}

// One lexicographic reduce of the NT threads' best end cells over `red`
// (5 * NT int32: score, j, i, query start, target start rows), the
// winner left in each row's first entry
template <int NT>
__device__ __forceinline__ void block_reduce(int32_t* red, const Best& best) {
    const int tid = threadIdx.x;
    int32_t* r_s = red;
    int32_t* r_j = r_s + NT;
    int32_t* r_i = r_j + NT;
    int32_t* r_qs = r_i + NT;
    int32_t* r_ts = r_qs + NT;
    r_s[tid] = best.s;
    r_j[tid] = best.j;
    r_i[tid] = best.i;
    r_qs[tid] = best.qs;
    r_ts[tid] = best.ts;
    __syncthreads();
    for (int off = NT / 2; off > 0; off >>= 1) {
        if (tid < off) {
            const int o = tid + off;
            if (better(r_s[o], r_j[o], r_i[o], r_s[tid], r_j[tid], r_i[tid])) {
                r_s[tid] = r_s[o];
                r_j[tid] = r_j[o];
                r_i[tid] = r_i[o];
                r_qs[tid] = r_qs[o];
                r_ts[tid] = r_ts[o];
            }
        }
        __syncthreads();
    }
}

// pair b's (score, i, j, query start, target start) from a reduce's rows
template <int NT>
__device__ __forceinline__ void write_out(const Params& p, int b,
                                          const int32_t* red) {
    const bool found = red[0] > NEG;
    p.out[0 * p.B + b] = found ? red[0] : NEG;
    p.out[1 * p.B + b] = found ? red[2 * NT] : 0;
    p.out[2 * p.B + b] = found ? red[NT] : 0;
    p.out[3 * p.B + b] = found ? red[3 * NT] : 0;
    p.out[4 * p.B + b] = found ? red[4 * NT] : 0;
}

// Kernels K1 (score and region modes) and K4 (path mode): one CTA per
// pair, the carry ring in global memory, a block barrier per diagonal.
// MASKED: the batch carries a SubOpt mask plane (K3).
template <bool MASKED>
__global__ void __launch_bounds__(PT) plan_kernel(const Params p) {
    constexpr int R = IP::R;
    __shared__ int32_t red[5 * PT];
    const int tid = threadIdx.x;
    const int b = blockIdx.x;
    const Pair c = pair_of(p, b);
    const GlobalRing<false> rg{p.ring + (size_t)b * R * IP::NR * c.W,
                               p.lring + (size_t)b * R * IP::NL * c.W, c.W};
    const int TB = (p.Tp + 8) >> 3;   // bytes per mask row
    const uint8_t* blk_rows = MASKED ? p.blocked + (size_t)b * c.W * TB
                                     : nullptr;
    Best best;
    const int n_diag = c.qlen + c.tlen + 1;
    for (int d = 0; d < n_diag; ++d) {
        const int lo = d - c.tlen > 0 ? d - c.tlen : 0;
        const int hi = d < c.qlen ? d : c.qlen;
        const int slot = d % R;
        uint8_t* tb_d = IP::MODE == MODE_PATH
            ? p.tb + ((size_t)b * (p.Qp + p.Tp + 1) + d) * IP::S * c.W
            : nullptr;
        for (int i = lo + tid; i <= hi; i += PT) {
            const int j = d - i;
            const bool blk = MASKED
                && ((blk_rows[(size_t)i * TB + (j >> 3)] >> (7 - (j & 7)))
                    & 1);
            run_cell<MASKED>(c, rg, i, j, slot, blk, tb_d, best);
        }
        __syncthreads();
    }
    block_reduce<PT>(red, best);
    if (tid == 0) write_out<PT>(p, b, red);
}

// Kernel K2, the cluster wavefront (score and region modes; path mode
// is K4 on a cluster: the checkpointed traceback's segments, over the
// span [p.d_begin, p.d_end) of the diagonals, and masked path DPs over
// all of them): plan_kernel's cells (run_cell), each pair run by a
// thread-block cluster of C CTAs so that one long pair (B=1 against a
// chromosome-scale target) spans C SMs.  Grid B x C, cluster (C, 1, 1).
// Rows are stationary: rank r owns the query rows [r*RB, (r+1)*RB), RB =
// k*THREADS, and thread tid the rows r*RB + tid + m*THREADS, m < k, for
// the whole launch (a row is idle on a diagonal outside [lo, hi]).
//
// SMEM_RING (cuda_wavefront.ring_in_smem: where the ring fits a CTA's
// shared memory): the CTA keeps its rows' ring (SharedRing).  A source
// row i - aq (aq <= K) is this CTA's, or one of the H rows below it,
// which belong to rank r-1: at the start of each diagonal warp 0 copies
// rank r-1's top H rows of the diagonal before (of the K before, at a
// launch's first diagonal) into the halo through distributed shared
// memory (cluster.map_shared_rank), so every read in a cell is a load
// from the CTA's own shared memory.  Without SMEM_RING (protein2genome,
// coding2genome and cdna2genome in region mode at Qp 2304, whose rings
// are over a CTA's shared memory) the ring is the global (ring, lring)
// pair, read past L1 as the other CTAs of the cluster write it.
//
// Why one cluster barrier per diagonal suffices: at diagonal d every CTA
// writes only slot d % R of its own rows and reads slots (d - adv) % R
// with 1 <= adv <= K, never d % R as R = K+1; the halo copy reads rank
// r-1's slot (d-1) % R, which that CTA wrote before the barrier ending
// d-1 and rewrites no earlier than d-1+R > d, and writes the halo's slot
// (d-1) % R, which only warp 0 reads, after __syncwarp.
//
// A segment of the checkpointed traceback loads its rows' slots of the K
// diagonals before it from the global (ring, lring) pair before its first
// diagonal and stores the slots of its last R diagonals back after its
// last (p.ring_io), so that the global ring's contract
// (wavefront.plain_wavefront(ki, span, ring)) is unchanged; a whole scan
// touches no global ring.  (Without SMEM_RING a segment runs on the
// global pair itself.)  MASKED: a row's mask byte is kept in shared
// memory and reloaded once per 8 cells (j grows by one per diagonal along
// a row), at j % 8 == 0 and at the row's first live diagonal of the
// launch.  The end cell: each CTA reduces its threads as K1 does, then
// rank 0 reads the C block results through distributed shared memory and
// reduces them in rank order with the same lexicographic key, and a last
// cluster barrier keeps the CTAs resident until it has.  Shared memory
// (smem_bytes + ring_smem_bytes): the block reduce, the mask bytes, the
// ring.
template <bool MASKED, bool SMEM_RING>
__global__ void __launch_bounds__(THREADS)
ring_kernel(const Params p) {
    constexpr int R = IP::R, H = R - 1;
    constexpr int NR = IP::NR, NL = IP::NL, NRL = NR + NL;
    extern __shared__ __align__(16) int32_t smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x;
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / C;
    const Pair c = pair_of(p, b);
    const int W = c.W;
    int32_t* ring = p.ring + (size_t)b * R * NR * W;
    int32_t* lring = p.lring + (size_t)b * R * NL * W;
    const int TB = (p.Tp + 8) >> 3;   // bytes per mask row
    const uint8_t* blk_rows = MASKED ? p.blocked + (size_t)b * W * TB
                                     : nullptr;
    Best best;

    const int n_diag = c.qlen + c.tlen + 1;
    const int d_first = p.d_begin;
    const int d_stop = p.d_end < n_diag ? p.d_end : n_diag;

    // this CTA's rows [row0, row0 + RB); after the block reduce, the mask
    // bytes of its rows and its ring
    const int RB = p.k * THREADS;
    const int WB = RB + H;
    const int row0 = rank * RB;
    const int row_end = row0 + RB - 1;
    int32_t* red = smem;
    int32_t* s_mask = red + 5 * THREADS;
    int32_t* s_ring = s_mask + (MASKED ? RB : 0);
    const SharedRing sr{s_ring, H - row0, WB};
    using Ring = std::conditional_t<SMEM_RING, SharedRing, GlobalRing<true>>;
    Ring rg;
    if constexpr (SMEM_RING) rg = sr;
    else rg = GlobalRing<true>{ring, lring, W};
    // rank - 1's ring (DSMEM)
    const int32_t* nb_ring = SMEM_RING && rank > 0
        ? cluster.map_shared_rank(s_ring, rank - 1) : nullptr;
    // this thread's first row at or after lo
    auto first_own = [&](int lo) -> int {
        const int r = row0 + tid;
        return lo <= r ? r : r + (lo - r + THREADS - 1) / THREADS * THREADS;
    };
    // copy this thread's rows of diagonal dd between the shared ring and
    // the global (ring, lring) pair, slot dd % R, its valid cells only
    auto ring_copy = [&](int dd, bool store) {
        const int sl = dd % R;
        const int lo = dd - c.tlen > 0 ? dd - c.tlen : 0;
        const int hi = dd < c.qlen ? dd : c.qlen;
        for (int i = first_own(lo); i <= hi && i <= row_end; i += THREADS) {
            each<0, NR>([&](auto rr) {
                int32_t* g = ring + ((size_t)sl * NR + rr) * W + i;
                if (store) *g = sr.at(sl, rr, i);
                else sr.at(sl, rr, i) = *g;
            });
            each<0, NL>([&](auto lr) {
                int32_t* g = lring + ((size_t)sl * NL + lr) * W + i;
                if (store) *g = sr.at(sl, NR + lr, i);
                else sr.at(sl, NR + lr, i) = *g;
            });
        }
    };
    // this lane's (ring row, halo row) pairs of a slot in the halo copy,
    // pair x = u * 32 + lane at ring row x / H, halo row x % H
    int h_off[HALO_LOADS];
#pragma unroll
    for (int u = 0; u < HALO_LOADS; ++u) {
        const int x = u * 32 + tid;
        h_off[u] = x < H * NRL ? x / H * WB + x % H : -1;
    }
    if (SMEM_RING && (p.ring_io & RING_LOAD))
        for (int dd = d_first - H > 0 ? d_first - H : 0; dd < d_first; ++dd)
            ring_copy(dd, false);
    // every CTA has started (its shared memory may be read) and holds its
    // loaded rows
    cluster.sync();

    for (int d = d_first; d < d_stop; ++d) {
        const int lo = d - c.tlen > 0 ? d - c.tlen : 0;
        const int hi = d < c.qlen ? d : c.qlen;
        const int slot = d % R;
        // the halo: rank - 1's top H rows of the diagonal before (of the H
        // before, at the launch's first), copied by warp 0, whose threads
        // tid < H read it, each lane's HALO_LOADS loads in flight at once
        if (SMEM_RING && rank > 0 && tid < 32) {
            for (int dd = d == d_first ? (d > H ? d - H : 0) : d - 1; dd < d;
                 ++dd) {
                const int base = dd % R * NRL * WB;
                int32_t v[HALO_LOADS];
#pragma unroll
                for (int u = 0; u < HALO_LOADS; ++u)
                    if (h_off[u] >= 0) v[u] = nb_ring[base + h_off[u] + RB];
#pragma unroll
                for (int u = 0; u < HALO_LOADS; ++u)
                    if (h_off[u] >= 0) s_ring[base + h_off[u]] = v[u];
                for (int x = 32 * HALO_LOADS + tid; x < H * NRL; x += 32) {
                    const int at = base + x / H * WB + x % H;
                    s_ring[at] = nb_ring[at + RB];
                }
            }
        }
        __syncwarp();
        uint8_t* tb_d = IP::MODE == MODE_PATH
            ? p.tb + ((size_t)b * (p.d_end - p.d_begin) + (d - d_first))
                  * IP::S * W
            : nullptr;
        const int i_last = hi < row_end ? hi : row_end;
        for (int i = first_own(lo); i <= i_last; i += THREADS) {
            const int j = d - i;
            bool blk = false;
            if constexpr (MASKED) {
                // the row's mask byte, reloaded once per 8 cells
                int32_t& byte = s_mask[i - row0];
                if ((j & 7) == 0 || d == d_first)
                    byte = blk_rows[(size_t)i * TB + (j >> 3)];
                blk = (byte >> (7 - (j & 7))) & 1;
            }
            run_cell<MASKED>(c, rg, i, j, slot, blk, tb_d, best);
        }
        cluster.sync();
    }
    // the slots of the last R diagonals, for the segment after this one
    // (each thread stores the rows it wrote)
    if (SMEM_RING && (p.ring_io & RING_STORE))
        for (int dd = d_stop - R > d_first ? d_stop - R : d_first;
             dd < d_stop; ++dd)
            ring_copy(dd, true);

    block_reduce<THREADS>(red, best);
    cluster.sync();     // every CTA's block result is in its smem
    if (rank == 0 && tid == 0) {
        for (int r = 1; r < C; ++r) {
            const int32_t* o = cluster.map_shared_rank(red, r);
            const int32_t* o_j = o + THREADS;
            const int32_t* o_i = o_j + THREADS;
            if (better(o[0], o_j[0], o_i[0], red[0], red[THREADS],
                       red[2 * THREADS])) {
                red[0] = o[0];
                red[THREADS] = o_j[0];
                red[2 * THREADS] = o_i[0];
                red[3 * THREADS] = o_i[THREADS];
                red[4 * THREADS] = o_i[2 * THREADS];
            }
        }
        write_out<THREADS>(p, b, red);
    }
    // rank 0 has read every CTA's shared memory before any CTA exits
    cluster.sync();
}

// ring_kernel's dynamic shared memory beside its ring and mask bytes
// (cuda_wavefront.smem_bytes): the block reduce
size_t smem_bytes() {
    return sizeof(int32_t) * 5 * THREADS;
}

// ring_kernel's shared memory beyond smem_bytes
// (cuda_wavefront.ring_smem_bytes): each row's mask byte (an int32) when
// masked, and with smem_ring R slots of the NR + NL ring rows over the
// CTA's rows_per_thread * THREADS rows and the R - 1 halo rows below them
size_t ring_smem_bytes(int R, int NR, int NL, int rows_per_thread,
                       bool masked, bool smem_ring) {
    const size_t rb = (size_t)rows_per_thread * THREADS;
    return sizeof(int32_t)
        * ((masked ? rb : 0)
           + (smem_ring ? (size_t)R * (NR + NL) * (rb + R - 1) : 0));
}

// K2's launch configuration, C CTAs per pair.  cluster > 0 asks for that
// size; 0 takes C = min(ceil(rows / THREADS), Cmax), rows the widest
// diagonal of the batch (its largest qlen + 1) and Cmax the larger of
// MAX_CLUSTER (a non-portable size) and PORTABLE_CLUSTER that
// cudaOccupancyMaxActiveClusters admits at this launch's shared memory.
// It sets p.k = ceil(rows / (C * THREADS)) rows per thread, and the
// shared memory with it.  Fills cfg (grid, cluster, shared memory) and
// *resident, the clusters of C CTAs that fit on the card at once.  A
// size that cannot launch is an error: there is no fallback.
template <bool MASKED, bool SMEM_RING>
cudaError_t stream_plan(Params& p, int cluster, int rows,
                        cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                        int* resident) {
    auto kern = ring_kernel<MASKED, SMEM_RING>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (rows < 1) rows = 1;
    // clusters of size c that fit on the card at once (0: none fits),
    // leaving cfg and p.k set for c
    auto admitted = [&](int c) -> int {
        p.k = (rows + c * THREADS - 1) / (c * THREADS);
        const size_t smem = smem_bytes()
            + ring_smem_bytes(IP::R, IP::NR, IP::NL, p.k, MASKED, SMEM_RING);
        if (smem > MAX_SMEM
            || cudaFuncSetAttribute(
                   kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   (int)smem) != cudaSuccess) {
            (void)cudaGetLastError();
            return 0;
        }
        attr[0].val.clusterDim.x = c;
        cfg.gridDim = dim3(p.B * c, 1, 1);
        cfg.dynamicSmemBytes = smem;
        int n = 0;
        if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
            (void)cudaGetLastError();     // a refused size: not sticky
            return 0;
        }
        return n;
    };
    int C = cluster;
    if (C <= 0) {
        const int cmax = admitted(MAX_CLUSTER) > 0 ? MAX_CLUSTER
            : admitted(PORTABLE_CLUSTER) > 0 ? PORTABLE_CLUSTER : 0;
        if (cmax == 0) return cudaErrorInvalidConfiguration;
        const int want = (rows + THREADS - 1) / THREADS;
        C = want < cmax ? want : cmax;
    }
    if (C > MAX_CLUSTER) return cudaErrorInvalidConfiguration;
    *resident = admitted(C);
    return *resident < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// f(masked, smem_ring) with both as compile-time constants: ring_kernel's
// four instantiations
template <typename F>
cudaError_t with_ring_kernel(bool masked, bool smem_ring, F&& f) {
    auto ring = [&](auto ma) {
        return smem_ring ? f(ma, std::true_type{})
                         : f(ma, std::false_type{});
    };
    return masked ? ring(std::true_type{}) : ring(std::false_type{});
}

// The per-pair arguments that both launchers take; mode must be the
// plan's and tb given exactly in path mode (an error code otherwise)
int pair_params(Params& p, int mode, const int32_t* dims,
                const int32_t* qvecs, int nq, const int32_t* tvecs, int nt,
                const int32_t* tables, int ntab, const int32_t* scalars,
                int nsc, int32_t* ring, int32_t* lring, uint8_t* tb,
                int32_t* out, int B, int Qp, int Tp, int start_scope,
                int end_scope, const uint8_t* blocked) {
    if (mode != IP::MODE || (mode == MODE_PATH) != (tb != nullptr))
        return (int)cudaErrorInvalidValue;
    p = Params{};
    p.dims = dims;
    p.qvecs = qvecs;
    p.tvecs = tvecs;
    p.tables = tables;
    p.scalars = scalars;
    p.ring = ring;
    p.lring = lring;
    p.tb = tb;
    p.blocked = blocked;
    p.out = out;
    p.nq = nq;
    p.nt = nt;
    p.ntab = ntab;
    p.nsc = nsc;
    p.B = B;
    p.Qp = Qp;
    p.Tp = Tp;
    p.start_scope = start_scope;
    p.end_scope = end_scope;
    return 0;
}

}  // namespace

// K1/K4: the per-pair arguments only (the plan, storage map and model
// numbers are WavePlan's).  Returns the CUDA error of the launch.
extern "C" int wavefront_plan_launch(
    int mode, const int32_t* dims, const int32_t* qvecs, int nq,
    const int32_t* tvecs, int nt, const int32_t* tables, int ntab,
    const int32_t* scalars, int nsc, int32_t* ring, int32_t* lring,
    uint8_t* tb, int32_t* out, int B, int Qp, int Tp, int start_scope,
    int end_scope, const uint8_t* blocked, void* stream) {
    if (B <= 0) return 0;
    Params p;
    const int bad = pair_params(p, mode, dims, qvecs, nq, tvecs, nt, tables,
                                ntab, scalars, nsc, ring, lring, tb, out, B,
                                Qp, Tp, start_scope, end_scope, blocked);
    if (bad) return bad;
    cudaStream_t s = (cudaStream_t)stream;
    if (blocked != nullptr)
        plan_kernel<true><<<B, PT, 0, s>>>(p);
    else
        plan_kernel<false><<<B, PT, 0, s>>>(p);
    return (int)cudaGetLastError();
}

// The threads per CTA of this plan's K1/K4 (plan_threads).
extern "C" int wavefront_plan_threads() { return PT; }

// K2: K1's per-pair arguments, then the cluster size asked for (0: the
// rule of stream_plan), the batch's widest diagonal, the diagonals
// [d_begin, d_end) to run (a later segment continues the ring that the
// launch before it left), whether the carry ring lives in shared memory
// (cuda_wavefront.ring_in_smem) and, if so, its RING_LOAD / RING_STORE
// bits, and where to write the cluster size launched.  Score and region
// modes are K2; path mode (tb holding d_end - d_begin diagonals: a
// segment of the checkpointed traceback, or a masked path DP over all of
// them) is K4 on the cluster.
extern "C" int wavefront_stream_launch(
    int mode, const int32_t* dims, const int32_t* qvecs, int nq,
    const int32_t* tvecs, int nt, const int32_t* tables, int ntab,
    const int32_t* scalars, int nsc, int32_t* ring, int32_t* lring,
    uint8_t* tb, int32_t* out, int B, int Qp, int Tp, int start_scope,
    int end_scope, const uint8_t* blocked, int cluster, int rows,
    int d_begin, int d_end, int smem_ring, int ring_io, int* cluster_used,
    void* stream) {
    if (B <= 0) return 0;
    if (d_begin < 0 || d_end < d_begin) return (int)cudaErrorInvalidValue;
    Params p;
    const int bad = pair_params(p, mode, dims, qvecs, nq, tvecs, nt, tables,
                                ntab, scalars, nsc, ring, lring, tb, out, B,
                                Qp, Tp, start_scope, end_scope, blocked);
    if (bad) return bad;
    p.d_begin = d_begin;
    p.d_end = d_end;
    p.ring_io = ring_io;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)with_ring_kernel(
        blocked != nullptr, smem_ring != 0, [&](auto ma, auto sr) {
            constexpr bool M = decltype(ma)::value, SR = decltype(sr)::value;
            cudaLaunchAttribute attr[1];
            cudaLaunchConfig_t cfg;
            int resident = 0;
            cudaError_t err = stream_plan<M, SR>(p, cluster, rows, cfg, attr,
                                                 &resident);
            if (err != cudaSuccess) return err;
            cfg.stream = s;
            *cluster_used = (int)attr[0].val.clusterDim.x;
            err = cudaLaunchKernelEx(&cfg, ring_kernel<M, SR>, p);
            if (err != cudaSuccess) return err;
            return cudaGetLastError();
        });
}

// The cluster size K2 would launch for a batch of this plan and width
// (its rule, or the size asked for), written to *cluster_used, and how
// many such clusters are resident on the card at once, to *resident:
// cuda_wavefront routes a masked batch to the cluster kernel when all of
// its pairs' clusters are.
extern "C" int wavefront_stream_capacity(int masked, int smem_ring,
                                         int rows, int cluster,
                                         int* cluster_used, int* resident) {
    Params p{};
    p.B = 1;
    return (int)with_ring_kernel(
        masked != 0, smem_ring != 0, [&](auto ma, auto sr) {
            cudaLaunchAttribute attr[1];
            cudaLaunchConfig_t cfg;
            const cudaError_t err =
                stream_plan<decltype(ma)::value, decltype(sr)::value>(
                    p, cluster, rows, cfg, attr, resident);
            if (err == cudaSuccess)
                *cluster_used = (int)attr[0].val.clusterDim.x;
            return err;
        });
}
