// Exhaustive anti-diagonal Viterbi for a batch of pairs: K1 (score and
// region modes), K4 (path mode) and K2 (the streamed wavefront, score and
// region modes), hand-written for Hopper (sm_90a).
//
// Replaces exonerate_tpu/engine/pallas_wavefront.py: the Pallas kernel
// built by build_pallas_wavefront (:427; body `kernel` :593 and
// `_one_diagonal` :722), in modes score/region, and its path mode
// (:1147-1150), which also writes each state's winning plan id per cell.
//
// What it computes.  One CTA per pair.  The CTA loops over all
// qlen+tlen+1 anti-diagonals d = i + j; its threads own the cells of a
// diagonal at i = lo + tid + k*blockDim, and one __syncthreads() per
// diagonal orders the writes of diagonal d before the reads of d+1.  Per
// cell, the plan table (one int32 row per transition of _build_plan, in
// model order; engine/wavefront.py defines the columns) is interpreted
// row by row: source cell, calc, shadow check, clamps, then a strictly
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
// What bounds it on the H100.  Not arithmetic: the carry ring.  A
// (K+1)-diagonal ring of every state read across diagonals, plus the
// live shadow/region lanes, is about 0.5 MB per 2175^2 pair, far over
// the 227 KB of shared memory a block may hold, so it lives in global
// memory and stays resident in the 50 MB L2 (B=64 is ~32 MB).  Every
// cell reads its source rows from L2 and writes its own, and every
// diagonal ends in a block-wide barrier, so the kernel is bound by L2
// latency and the per-diagonal barrier.  The design keeps what it can
// out of L2: the plan table and the storage map live in shared memory,
// each thread's per-cell state (S scores, S*L lanes, S ids) lives in
// shared memory in a [var][thread] layout free of bank conflicts, the
// running best end cell lives in registers, only states that a later
// diagonal reads get ring rows, and only live (state, lane) slots are
// stored (_storage_plan).  64 CTAs fill 64 of the 132 SMs; speed is
// later work.
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
// threads for the whole launch.  Where the pair's carry ring fits shared
// memory beside the cell state (cuda_wavefront.ring_in_smem: est2genome
// in every mode, protein2genome in score and path modes) each CTA keeps
// its own rows' ring in shared memory, and the K rows below a CTA's
// first come from its neighbour through distributed shared memory, once
// per diagonal; elsewhere (its SMEM_RING flag false) the ring is in
// global memory, as in K1.  ring_kernel repeats wavefront_kernel's cell
// body, and both are held to the same plain version.
//
// What bounds ring_kernel with the shared ring: no longer the ring's L2 round trips but one
// cell's chain of dependent work per thread per diagonal, with 8 warps on
// each of the C SMs to hide it: the plan's interpretation (shared-memory
// loads and branches per plan row; est2genome has 24 rows), the calcs'
// loads of the query and target vectors from global memory, and a floor
// of the cluster barrier, the cell state's initialisation and the ring
// writes.  The design reads a plan row's fields in four 16-byte loads,
// keeps each row's ring source row in the plan copy, and wraps ring slots
// without a division; compiling the plan into the kernel, or spreading a
// cell's plan rows over several threads, is the next lever (PERF.md).
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

namespace cg = cooperative_groups;

namespace {

constexpr int32_t NEG = -987654321;       // IMPOSSIBLY_LOW_SCORE
constexpr int32_t HIGH = 987654321;       // IMPOSSIBLY_HIGH_SCORE
constexpr int THREADS = 256;              // a power of two (final reduce)
constexpr int MAX_L = 6;                  // lanes per state (cuda_wavefront)
constexpr int LEAN_L = 4;                 // ... in the lean instantiation
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
constexpr int PLAN_COLS = 28;    // a row is 7 x 16 bytes (aligned loads)
constexpr int RING_COL = 26;     // a padding column (ring_kernel's copy)
static_assert(P_AQ == 0 && P_AT == 1 && P_IN == 2 && P_OUT == 3
              && P_FLAGS == 4 && P_CALC == 5 && P_C0 == 6 && P_C1 == 7
              && P_C2 == 8 && P_C3 == 9 && P_C4 == 10 && P_SH_LANE_Q == 11
              && P_SH_LANE_T == 12 && P_SH_MIN == 13 && P_SH_MAX == 14
              && P_ST_SRC0 + 2 * 3 < RING_COL,
              "ring_kernel reads columns 0-15 as four int4");

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

struct Params {
    const int32_t* plan;        // (n_plan, PLAN_COLS)
    const int32_t* ring_row;    // (S,)
    const int32_t* lane_row;    // (S, max(L, 1))
    const int32_t* dims;        // (B, 4): qstart, tstart, qlen, tlen
    const int32_t* qvecs;       // (B, nq, Qp+1)
    const int32_t* tvecs;       // (B, nt, Tp+1)
    const int32_t* tables;      // (B, ntab)
    const int32_t* scalars;     // (B, nsc)
    int32_t* ring;              // (B, R, NR, Qp+1)
    int32_t* lring;             // (B, R, NL, Qp+1)
    uint8_t* tb;                // (B, Qp+Tp+1, S, Qp+1), path mode
    const uint8_t* blocked;     // (B, Qp+1, ceil((Tp+1)/8)), MASKED
    int32_t* out;               // (5, B)
    int nq, nt, ntab, nsc;
    int n_plan, B, Qp, Tp, S, L, NR, NL, R, n_shadow;
    int start_id, end_id, start_scope, end_scope;
    // ring_kernel only: the diagonals [d_begin, d_end) of this launch, which
    // continues the carry ring a launch over [0, d_begin) left (a segment
    // of the checkpointed traceback); tb then holds d_end - d_begin
    // diagonals, diagonal d at d - d_begin
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

// floor division and modulo by 6, as jnp's // and % on int32
__device__ __forceinline__ int floordiv6(int32_t x) {
    const int q = x / 6;
    return (x % 6 != 0 && x < 0) ? q - 1 : q;
}

// Kernel K9, the split-codon score (model/phase.py:305-327,
// _make_split_pallas_fn), evaluated as one calc kind of the plan.  The
// amino acid of a codon split by an intron is decoded from packed 5-bit
// fields: phase 1 selects one of three target rows E1p0..2 (C1..C1+2) at
// the source column by the "split c1" lane (C4) // 6, phase 2 one of the
// lanes "split p2k0..2" (C4..C6) by the N4 row (C1) at the source column
// // 6; the field is the selector % 6.  The aa then indexes the 25 query
// rows R0..R24 (C0..C0+24, already shifted by aq on the host) directly:
// one load, no 25-way select.  aa 25..31 scores 0; a cell whose "target
// intron" lane (C3, the intron's absolute start) is below the phase
// scores NEG.
template <typename Lane>
__device__ __forceinline__ int32_t split_codon(
    const int32_t* row, const Lane& src_lane, const int32_t* qv,
    const int32_t* tv, int W, int WT, int i, int sj) {
    const int phase = row[P_C2];
    if (!(src_lane(row[P_C3]) >= phase)) return NEG;
    int32_t sel, sub = 0;
    if (phase == 1) {
        sel = src_lane(row[P_C4]);
        const int k = floordiv6(sel);
        if (k >= 0 && k < 3) sub = tv[(row[P_C1] + k) * WT + sj];
    } else {
        sel = tv[row[P_C1] * WT + sj];
        const int k = floordiv6(sel);
        if (k >= 0 && k < 3)
            sub = src_lane(row[k == 0 ? P_C4 : k == 1 ? P_C5 : P_C6]);
    }
    int field = sel % 6;
    if (field < 0) field += 6;
    const int aa = (sub >> (5 * field)) & 31;
    return aa < 25 ? qv[(row[P_C0] + aa) * W + i] : 0;
}

// FULL: the plan may hold kernel K9's pieces (a C_SPLIT row or a start
// lane read from a tvec) and up to MAX_L lanes per state.  The lean
// instantiation (!FULL) serves the other plans, up to LEAN_L lanes, with
// the split-codon body and the vector start decode compiled out, so that
// the models served before K9 keep the code they had.  MASKED: the batch
// carries a SubOpt mask plane (K3); the mask-free launches keep the code
// they had.
//
// Kernels K1 (score and region modes) and K4 (path mode): one CTA per
// pair, the carry ring in global memory, a block barrier per diagonal.
// The cluster kernel (ring_kernel below) runs the same cells and plan
// semantics on a cluster of CTAs; both are held to the same plain
// version.
template <int MODE, bool FULL, bool MASKED>
__global__ void __launch_bounds__(THREADS)
wavefront_kernel(const Params p) {
    extern __shared__ __align__(16) int32_t smem[];
    const int tid = threadIdx.x;
    // the end-cell test is written as the cluster kernel's (rank 0
    // writes): without it ptxas orders two register initialisations
    // otherwise (tools/torch_wavefront_sass.py holds K1/K4's SASS)
    const int rank = 0;
    const int b = blockIdx.x;
    const int S = p.S, L = p.L;
    int32_t* s_plan = smem;
    int32_t* s_ring_row = s_plan + p.n_plan * PLAN_COLS;
    int32_t* s_lane_row = s_ring_row + S;
    int32_t* s_cell = s_lane_row + S * (L > 0 ? L : 1);
    for (int k = tid; k < p.n_plan * PLAN_COLS; k += THREADS)
        s_plan[k] = p.plan[k];
    for (int k = tid; k < S; k += THREADS) s_ring_row[k] = p.ring_row[k];
    for (int k = tid; k < S * (L > 0 ? L : 1); k += THREADS)
        s_lane_row[k] = p.lane_row[k];
    __syncthreads();

    // per-thread cell state, variable v of this thread at s_cell[v*T+tid]
    const int V_LN = S, V_TB = S + S * L;
#define CV(v) s_cell[(v) * THREADS + tid]

    const int32_t qstart = p.dims[b * 4 + 0], tstart = p.dims[b * 4 + 1];
    const int32_t qlen = p.dims[b * 4 + 2], tlen = p.dims[b * 4 + 3];
    const int W = p.Qp + 1, WT = p.Tp + 1, R = p.R;
    const int NR = p.NR, NL = p.NL;
    const int32_t* qv = p.qvecs + (size_t)b * p.nq * W;
    const int32_t* tv = p.tvecs + (size_t)b * p.nt * WT;
    const int32_t* tab = p.tables + (size_t)b * p.ntab;
    const int32_t* sc = p.scalars + (size_t)b * p.nsc;
    int32_t* ring = p.ring + (size_t)b * R * NR * W;
    int32_t* lring = p.lring + (size_t)b * R * NL * W;
    const int rs_q = p.n_shadow, rs_t = p.n_shadow + 1;
    const int TB = (p.Tp + 8) >> 3;   // bytes per mask row
    const uint8_t* blk_rows = MASKED ? p.blocked + (size_t)b * W * TB
                                     : nullptr;

    int32_t best_s = NEG, best_j = INT32_MAX, best_i = INT32_MAX;
    int32_t best_qs = 0, best_ts = 0;

    const int n_diag = qlen + tlen + 1;
    for (int d = 0; d < n_diag; ++d) {
        const int lo = d - tlen > 0 ? d - tlen : 0;
        const int hi = d < qlen ? d : qlen;
        const int slot = d % R;
        for (int i = lo + tid; i <= hi; i += THREADS) {
            const int j = d - i;
            const bool blk = MASKED
                && ((blk_rows[(size_t)i * TB + (j >> 3)] >> (7 - (j & 7)))
                    & 1);
            for (int s = 0; s < S; ++s) {
                CV(s) = NEG;
                for (int l = 0; l < L; ++l) CV(V_LN + s * L + l) = 0;
                if (MODE == MODE_PATH) CV(V_TB + s) = 0;
            }
            for (int r = 0; r < p.n_plan; ++r) {
                const int32_t* row = s_plan + r * PLAN_COLS;
                const int aq = row[P_AQ], at = row[P_AT];
                const int si = i - aq, sj = j - at;
                if (si < 0 || sj < 0) continue;
                const int flags = row[P_FLAGS];
                if (MASKED && blk && (flags & F_MATCH)) continue;
                const int in = row[P_IN], out = row[P_OUT];
                const int adv = aq + at;
                // source: START (0), this diagonal (silent), or the ring
                const int src_slot = adv ? (d - adv) % R : 0;
                int32_t base;
                if (flags & F_FROM_START) {
                    if (!start_ok(p.start_scope, si, sj)) continue;
                    base = 0;
                } else {
                    base = adv == 0
                        ? CV(in)
                        : ring[((size_t)src_slot * NR + s_ring_row[in]) * W
                               + si];
                    if (base <= NEG) continue;
                }
                if ((flags & F_TO_END)
                    && !end_ok(p.end_scope, i, j, qlen, tlen))
                    continue;
                auto src_lane = [&](int l) -> int32_t {
                    if (flags & F_FROM_START) return 0;
                    if (adv == 0) return CV(V_LN + in * L + l);
                    const int lr = s_lane_row[in * L + l];
                    return lr < 0 ? 0
                        : lring[((size_t)src_slot * NL + lr) * W + si];
                };
                int32_t calc = 0;
                switch (row[P_CALC]) {
                    case C_SCALAR: calc = sc[row[P_C0]]; break;
                    case C_QVEC: calc = qv[row[P_C0] * W + i]; break;
                    case C_TVEC: calc = tv[row[P_C0] * WT + sj]; break;
                    case C_FACTORED: {
                        const int32_t ov = qv[row[P_C4] * W + i];
                        calc = ov != 0 ? ov
                            : tab[row[P_C2] + qv[row[P_C0] * W + i] * row[P_C3]
                                  + tv[row[P_C1] * WT + sj]];
                        break;
                    }
                    case C_SPLIT:
                        if (FULL)
                            calc = split_codon(row, src_lane, qv, tv, W, WT,
                                               i, sj);
                        break;
                    case C_NONE: default: break;
                }
                if (flags & (F_SH_Q | F_SH_T)) {
                    const int32_t mn = sc[row[P_SH_MIN]];
                    const int32_t mx = sc[row[P_SH_MAX]];
                    bool bad = false;
                    if (flags & F_SH_Q) {
                        const int32_t len = wadd(
                            wsub(si + qstart, src_lane(row[P_SH_LANE_Q])), 2);
                        bad = bad || len < mn || len > mx;
                    }
                    if (flags & F_SH_T) {
                        const int32_t len = wadd(
                            wsub(sj + tstart, src_lane(row[P_SH_LANE_T])), 2);
                        bad = bad || len < mn || len > mx;
                    }
                    if (bad) calc = NEG;
                }
                int32_t val = wadd(base, calc);
                if ((flags & F_P_UNDER) && val < NEG) val = NEG;
                if ((flags & F_P_OVER) && val > HIGH) val = HIGH;
                if (val < NEG) val = NEG;
                if (!(val > CV(out))) continue;    // first max wins
                CV(out) = val;
                if (MODE == MODE_PATH) CV(V_TB + out) = r + 1;
                if (L > 0) {
                    int32_t nl[FULL ? MAX_L : LEAN_L];
                    for (int l = 0; l < L; ++l) nl[l] = src_lane(l);
                    for (int k = 0; k < row[P_NSTART]; ++k) {
                        const int src = row[P_ST_SRC0 + 2 * k];
                        nl[row[P_ST_DES0 + 2 * k]] =
                            src == ST_TARGET ? sj + tstart
                            : !FULL || src == ST_QUERY ? si + qstart
                            : tv[(src - ST_TVEC) * WT + sj];
                    }
                    if (MODE == MODE_REGION && (flags & F_FROM_START)) {
                        nl[rs_q] = si;
                        nl[rs_t] = sj;
                    }
                    for (int l = 0; l < L; ++l) CV(V_LN + out * L + l) = nl[l];
                }
            }
            // this cell's column of the new diagonal
            for (int s = 0; s < S; ++s) {
                const int rr = s_ring_row[s];
                if (rr >= 0) ring[((size_t)slot * NR + rr) * W + i] = CV(s);
                for (int l = 0; l < L; ++l) {
                    const int lr = s_lane_row[s * L + l];
                    if (lr >= 0)
                        lring[((size_t)slot * NL + lr) * W + i] =
                            CV(V_LN + s * L + l);
                }
                if constexpr (MODE == MODE_PATH)
                    p.tb[(((size_t)b * (p.Qp + p.Tp + 1) + d) * S + s) * W
                         + i] = (uint8_t)CV(V_TB + s);
            }
            const int32_t es = CV(p.end_id);
            if (es > NEG && better(es, j, i, best_s, best_j, best_i)) {
                best_s = es;
                best_j = j;
                best_i = i;
                if (MODE == MODE_REGION) {
                    best_qs = CV(V_LN + p.end_id * L + rs_q);
                    best_ts = CV(V_LN + p.end_id * L + rs_t);
                }
            }
        }
        __syncthreads();
    }
#undef CV

    // one lexicographic reduce over the block (the cell state is free now)
    int32_t* r_s = s_cell;
    int32_t* r_j = r_s + THREADS;
    int32_t* r_i = r_j + THREADS;
    int32_t* r_qs = r_i + THREADS;
    int32_t* r_ts = r_qs + THREADS;
    r_s[tid] = best_s;
    r_j[tid] = best_j;
    r_i[tid] = best_i;
    r_qs[tid] = best_qs;
    r_ts[tid] = best_ts;
    __syncthreads();
    for (int off = THREADS / 2; off > 0; off >>= 1) {
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
    if (rank == 0 && tid == 0) {
        const bool found = r_s[0] > NEG;
        p.out[0 * p.B + b] = found ? r_s[0] : NEG;
        p.out[1 * p.B + b] = found ? r_i[0] : 0;
        p.out[2 * p.B + b] = found ? r_j[0] : 0;
        p.out[3 * p.B + b] = found ? r_qs[0] : 0;
        p.out[4 * p.B + b] = found ? r_ts[0] : 0;
    }
}


// Kernel K2, the cluster wavefront (score and region modes; path mode
// is K4 on a cluster: the checkpointed traceback's segments, over the
// span [p.d_begin, p.d_end) of the diagonals, and masked path DPs over
// all of them): the cells and plan semantics of wavefront_kernel, each
// pair run by a thread-block cluster of C CTAs so that one long pair
// (B=1 against a chromosome-scale target) spans C SMs.  Grid B x C,
// cluster (C, 1, 1).  Rows are stationary: rank r owns the query rows
// [r*RB, (r+1)*RB), RB = k*THREADS, and thread tid the rows
// r*RB + tid + m*THREADS, m < k, for the whole launch (a row is idle on a
// diagonal outside [lo, hi]).
//
// SMEM_RING (cuda_wavefront.ring_in_smem: where the ring fits beside the
// cell state): the CTA keeps R = K+1 slots (slot d % R) of its rows' NR
// score and NL lane ring rows in shared memory, laid out
// [slot][ring row][H + local row] so that neighbouring threads hit
// neighbouring banks, with H = K halo rows below its first row.  A source
// row i - aq (aq <= K) is this CTA's, or one of the H rows below it,
// which belong to rank r-1: at the start of each diagonal warp 0 copies
// rank r-1's top H rows of the diagonal before (of the K before, at a
// launch's first diagonal) into the halo through distributed shared
// memory (cluster.map_shared_rank), so every read in a cell is a load
// from the CTA's own shared memory.  Without SMEM_RING (protein2genome
// and coding2genome in region mode, whose rings are over a CTA's shared
// memory) the ring is the global (ring, lring) pair, read past L1 as the
// other CTAs of the cluster write it.
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
// cluster barrier keeps the CTAs resident until it has.
template <int MODE, bool FULL, bool MASKED, bool SMEM_RING>
__global__ void __launch_bounds__(THREADS)
ring_kernel(const Params p) {
    extern __shared__ __align__(16) int32_t smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x;
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / C;
    const int S = p.S, L = p.L;
    int32_t* s_plan = smem;
    int32_t* s_ring_row = s_plan + p.n_plan * PLAN_COLS;
    int32_t* s_lane_row = s_ring_row + S;
    int32_t* s_cell = s_lane_row + S * (L > 0 ? L : 1);
    for (int k = tid; k < p.n_plan * PLAN_COLS; k += THREADS)
        s_plan[k] = p.plan[k];
    for (int k = tid; k < S; k += THREADS) s_ring_row[k] = p.ring_row[k];
    for (int k = tid; k < S * (L > 0 ? L : 1); k += THREADS)
        s_lane_row[k] = p.lane_row[k];
    __syncthreads();

    // per-thread cell state, variable v of this thread at s_cell[v*T+tid]
    const int V_LN = S, V_TB = S + S * L;
#define CV(v) s_cell[(v) * THREADS + tid]

    const int32_t qstart = p.dims[b * 4 + 0], tstart = p.dims[b * 4 + 1];
    const int32_t qlen = p.dims[b * 4 + 2], tlen = p.dims[b * 4 + 3];
    const int W = p.Qp + 1, WT = p.Tp + 1, R = p.R;
    const int NR = p.NR, NL = p.NL;
    const int32_t* qv = p.qvecs + (size_t)b * p.nq * W;
    const int32_t* tv = p.tvecs + (size_t)b * p.nt * WT;
    const int32_t* tab = p.tables + (size_t)b * p.ntab;
    const int32_t* sc = p.scalars + (size_t)b * p.nsc;
    int32_t* ring = p.ring + (size_t)b * R * NR * W;
    int32_t* lring = p.lring + (size_t)b * R * NL * W;
    const int rs_q = p.n_shadow, rs_t = p.n_shadow + 1;
    const int TB = (p.Tp + 8) >> 3;   // bytes per mask row
    const uint8_t* blk_rows = MASKED ? p.blocked + (size_t)b * W * TB
                                     : nullptr;

    int32_t best_s = NEG, best_j = INT32_MAX, best_i = INT32_MAX;
    int32_t best_qs = 0, best_ts = 0;

    const int n_diag = qlen + tlen + 1;
    const int d_first = p.d_begin;
    const int d_stop = p.d_end < n_diag ? p.d_end : n_diag;

    // this CTA's rows [row0, row0 + RB), its ring (after the cell state:
    // smem_bytes + ring_smem_bytes) and the mask bytes of its rows;
    // SR(slot, ring row, i) is row i's entry, lane row lr at NR + lr
    const int H = R - 1, NRL = NR + NL;
    const int RB = p.k * THREADS;
    const int WB = RB + H;
    const int row0 = rank * RB;
    const int row_end = row0 + RB - 1;
    int cell_vars = S + S * L + (MODE == MODE_PATH ? S : 0);
    if (cell_vars < 5) cell_vars = 5;
    int32_t* s_ring = s_cell + cell_vars * THREADS;
    int32_t* s_mask = s_ring + (SMEM_RING ? R * NRL * WB : 0);
    // the cell variable each ring row stores (-1: a padding row)
    int32_t* s_wvar = s_mask + (MASKED ? RB : 0);
    for (int k = tid; k < NRL; k += THREADS) s_wvar[k] = -1;
    __syncthreads();
    // the ring row of each plan row's input state, in a padding column
    for (int r = tid; r < p.n_plan; r += THREADS)
        s_plan[r * PLAN_COLS + RING_COL] =
            s_ring_row[s_plan[r * PLAN_COLS + P_IN]];
    for (int st = tid; st < S; st += THREADS) {
        if (s_ring_row[st] >= 0) s_wvar[s_ring_row[st]] = st;
        for (int l = 0; l < L; ++l) {
            const int lr = s_lane_row[st * L + l];
            if (lr >= 0) s_wvar[NR + lr] = V_LN + st * L + l;
        }
    }
    __syncthreads();
    // rank - 1's ring (DSMEM)
    const int32_t* nb_ring = SMEM_RING && rank > 0
        ? cluster.map_shared_rank(s_ring, rank - 1) : nullptr;
#define SR(sl, rr, ii) s_ring[((sl) * NRL + (rr)) * WB + H + (ii) - row0]
    // a source entry of the ring: score row rr, or lane row lr
    auto ld_score = [&](int sl, int rr, int ii) -> int32_t {
        if constexpr (SMEM_RING) return SR(sl, rr, ii);
        else return __ldcg(ring + ((size_t)sl * NR + rr) * W + ii);
    };
    auto ld_lane = [&](int sl, int lr, int ii) -> int32_t {
        if constexpr (SMEM_RING) return SR(sl, NR + lr, ii);
        else return __ldcg(lring + ((size_t)sl * NL + lr) * W + ii);
    };
    // this thread's first row at or after lo
    auto first_own = [&](int lo) -> int {
        const int r = row0 + tid;
        return lo <= r ? r : r + (lo - r + THREADS - 1) / THREADS * THREADS;
    };
    // copy this thread's rows of diagonal dd between the shared ring and
    // the global (ring, lring) pair, slot dd % R, its valid cells only
    auto ring_copy = [&](int dd, bool store) {
        const int sl = dd % R;
        const int lo = dd - tlen > 0 ? dd - tlen : 0;
        const int hi = dd < qlen ? dd : qlen;
        for (int i = first_own(lo); i <= hi && i <= row_end; i += THREADS) {
            for (int rr = 0; rr < NR; ++rr) {
                int32_t* g = ring + ((size_t)sl * NR + rr) * W + i;
                if (store) *g = SR(sl, rr, i);
                else SR(sl, rr, i) = *g;
            }
            for (int lr = 0; lr < NL; ++lr) {
                int32_t* g = lring + ((size_t)sl * NL + lr) * W + i;
                if (store) *g = SR(sl, NR + lr, i);
                else SR(sl, NR + lr, i) = *g;
            }
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
        const int lo = d - tlen > 0 ? d - tlen : 0;
        const int hi = d < qlen ? d : qlen;
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
            // the cell's state: S scores NEG, then S*L lanes (and in path
            // mode S plan ids) 0
#pragma unroll 4
            for (int v = 0; v < S; ++v) CV(v) = NEG;
#pragma unroll 4
            for (int v = V_LN; v < V_TB + (MODE == MODE_PATH ? S : 0); ++v)
                CV(v) = 0;
            for (int r = 0; r < p.n_plan; ++r) {
                const int32_t* row = s_plan + r * PLAN_COLS;
                // columns 0-15 of the row in registers: four 16-byte
                // loads issued together, not a load per field on the
                // cell's dependent chain
                const int4* r4 = reinterpret_cast<const int4*>(row);
                const int4 f0 = r4[0], f1 = r4[1], f2 = r4[2], f3 = r4[3];
                const int src_rr = row[RING_COL];
                const int aq = f0.x, at = f0.y;
                const int si = i - aq, sj = j - at;
                if (si < 0 || sj < 0) continue;
                const int flags = f1.x;
                if (MASKED && blk && (flags & F_MATCH)) continue;
                const int in = f0.z, out = f0.w;
                const int adv = aq + at;
                // source: START (0), this diagonal (silent), or the ring
                // (slot - adv wrapped once, adv <= K < R: no division by
                // the run-time R)
                const int src_slot = !adv ? 0
                    : slot >= adv ? slot - adv : slot - adv + R;
                int32_t base;
                if (flags & F_FROM_START) {
                    if (!start_ok(p.start_scope, si, sj)) continue;
                    base = 0;
                } else {
                    base = adv == 0 ? CV(in) : ld_score(src_slot, src_rr, si);
                    if (base <= NEG) continue;
                }
                if ((flags & F_TO_END)
                    && !end_ok(p.end_scope, i, j, qlen, tlen))
                    continue;
                auto src_lane = [&](int l) -> int32_t {
                    if (flags & F_FROM_START) return 0;
                    if (adv == 0) return CV(V_LN + in * L + l);
                    const int lr = s_lane_row[in * L + l];
                    return lr < 0 ? 0 : ld_lane(src_slot, lr, si);
                };
                int32_t calc = 0;
                switch (f1.y) {                          // P_CALC
                    case C_SCALAR: calc = sc[f1.z]; break;
                    case C_QVEC: calc = qv[f1.z * W + i]; break;
                    case C_TVEC: calc = tv[f1.z * WT + sj]; break;
                    case C_FACTORED: {                   // C0..C4
                        const int32_t ov = qv[f2.z * W + i];
                        calc = ov != 0 ? ov
                            : tab[f2.x + qv[f1.z * W + i] * f2.y
                                  + tv[f1.w * WT + sj]];
                        break;
                    }
                    case C_SPLIT:
                        if (FULL)
                            calc = split_codon(row, src_lane, qv, tv, W, WT,
                                               i, sj);
                        break;
                    case C_NONE: default: break;
                }
                if (flags & (F_SH_Q | F_SH_T)) {
                    const int32_t mn = sc[f3.y];         // P_SH_MIN
                    const int32_t mx = sc[f3.z];         // P_SH_MAX
                    bool bad = false;
                    if (flags & F_SH_Q) {                // P_SH_LANE_Q
                        const int32_t len = wadd(
                            wsub(si + qstart, src_lane(f2.w)), 2);
                        bad = bad || len < mn || len > mx;
                    }
                    if (flags & F_SH_T) {                // P_SH_LANE_T
                        const int32_t len = wadd(
                            wsub(sj + tstart, src_lane(f3.x)), 2);
                        bad = bad || len < mn || len > mx;
                    }
                    if (bad) calc = NEG;
                }
                int32_t val = wadd(base, calc);
                if ((flags & F_P_UNDER) && val < NEG) val = NEG;
                if ((flags & F_P_OVER) && val > HIGH) val = HIGH;
                if (val < NEG) val = NEG;
                if (!(val > CV(out))) continue;    // first max wins
                CV(out) = val;
                if (MODE == MODE_PATH) CV(V_TB + out) = r + 1;
                if (L > 0) {
                    int32_t nl[FULL ? MAX_L : LEAN_L];
                    for (int l = 0; l < L; ++l) nl[l] = src_lane(l);
                    for (int k = 0; k < row[P_NSTART]; ++k) {
                        const int src = row[P_ST_SRC0 + 2 * k];
                        nl[row[P_ST_DES0 + 2 * k]] =
                            src == ST_TARGET ? sj + tstart
                            : !FULL || src == ST_QUERY ? si + qstart
                            : tv[(src - ST_TVEC) * WT + sj];
                    }
                    if (MODE == MODE_REGION && (flags & F_FROM_START)) {
                        nl[rs_q] = si;
                        nl[rs_t] = sj;
                    }
                    for (int l = 0; l < L; ++l) CV(V_LN + out * L + l) = nl[l];
                }
            }
            // this cell's column of the new diagonal: each ring row's
            // variable, then in path mode the plan ids
#pragma unroll 4
            for (int k = 0; k < NRL; ++k) {
                const int v = s_wvar[k];
                if (v < 0) continue;
                const int32_t x = s_cell[v * THREADS + tid];
                if constexpr (SMEM_RING) SR(slot, k, i) = x;
                else if (k < NR) ring[((size_t)slot * NR + k) * W + i] = x;
                else lring[((size_t)slot * NL + k - NR) * W + i] = x;
            }
            if constexpr (MODE == MODE_PATH)
                for (int s = 0; s < S; ++s)
                    p.tb[(((size_t)b * (p.d_end - p.d_begin) + (d - d_first))
                          * S + s) * W + i] = (uint8_t)CV(V_TB + s);
            const int32_t es = CV(p.end_id);
            if (es > NEG && better(es, j, i, best_s, best_j, best_i)) {
                best_s = es;
                best_j = j;
                best_i = i;
                if (MODE == MODE_REGION) {
                    best_qs = CV(V_LN + p.end_id * L + rs_q);
                    best_ts = CV(V_LN + p.end_id * L + rs_t);
                }
            }
        }
        cluster.sync();
    }
    // the slots of the last R diagonals, for the segment after this one
    // (each thread stores the rows it wrote)
    if (SMEM_RING && (p.ring_io & RING_STORE))
        for (int dd = d_stop - R > d_first ? d_stop - R : d_first;
             dd < d_stop; ++dd)
            ring_copy(dd, true);
#undef SR
#undef CV

    // one lexicographic reduce over the block (the cell state is free now)
    int32_t* r_s = s_cell;
    int32_t* r_j = r_s + THREADS;
    int32_t* r_i = r_j + THREADS;
    int32_t* r_qs = r_i + THREADS;
    int32_t* r_ts = r_qs + THREADS;
    r_s[tid] = best_s;
    r_j[tid] = best_j;
    r_i[tid] = best_i;
    r_qs[tid] = best_qs;
    r_ts[tid] = best_ts;
    __syncthreads();
    for (int off = THREADS / 2; off > 0; off >>= 1) {
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
    cluster.sync();     // every CTA's block result is in its smem
    if (rank == 0 && tid == 0) {
        for (int r = 1; r < C; ++r) {
            const int32_t* o = cluster.map_shared_rank(r_s, r);
            const int32_t* o_j = o + THREADS;
            const int32_t* o_i = o_j + THREADS;
            if (better(o[0], o_j[0], o_i[0], r_s[0], r_j[0], r_i[0])) {
                r_s[0] = o[0];
                r_j[0] = o_j[0];
                r_i[0] = o_i[0];
                r_qs[0] = o_i[THREADS];
                r_ts[0] = o_i[2 * THREADS];
            }
        }
    }
    if (rank == 0 && tid == 0) {
        const bool found = r_s[0] > NEG;
        p.out[0 * p.B + b] = found ? r_s[0] : NEG;
        p.out[1 * p.B + b] = found ? r_i[0] : 0;
        p.out[2 * p.B + b] = found ? r_j[0] : 0;
        p.out[3 * p.B + b] = found ? r_qs[0] : 0;
        p.out[4 * p.B + b] = found ? r_ts[0] : 0;
    }
    // rank 0 has read every CTA's shared memory before any CTA exits
    cluster.sync();
}


// dynamic shared memory of a CTA (cuda_wavefront.smem_bytes)
template <int MODE>
size_t smem_bytes(const Params& p) {
    const int lanes = p.L > 0 ? p.L : 1;
    int cell_vars = p.S + p.S * p.L + (MODE == MODE_PATH ? p.S : 0);
    if (cell_vars < 5) cell_vars = 5;   // the final reduce reuses it
    return sizeof(int32_t)
        * ((size_t)p.n_plan * PLAN_COLS + p.S + (size_t)p.S * lanes
           + (size_t)cell_vars * THREADS);
}

// ring_kernel's shared memory beyond smem_bytes
// (cuda_wavefront.ring_smem_bytes): with smem_ring, R slots of the NR + NL
// ring rows over the CTA's rows_per_thread * THREADS rows and the R - 1
// halo rows below them; each row's mask byte (an int32) when masked; and
// the cell variable of each ring row
size_t ring_smem_bytes(const Params& p, int rows_per_thread, bool masked,
                       bool smem_ring) {
    const size_t rb = (size_t)rows_per_thread * THREADS;
    return sizeof(int32_t)
        * ((smem_ring ? (size_t)p.R * (p.NR + p.NL) * (rb + p.R - 1) : 0)
           + (masked ? rb : 0) + p.NR + p.NL);
}

template <int MODE, bool FULL, bool MASKED>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    const size_t smem = smem_bytes<MODE>(p);
    cudaError_t err = cudaFuncSetAttribute(
        wavefront_kernel<MODE, FULL, MASKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    wavefront_kernel<MODE, FULL, MASKED>
        <<<p.B, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const Params& p, bool full, bool masked,
                   cudaStream_t stream) {
    if (masked)
        return full ? launch<MODE, true, true>(p, stream)
                    : launch<MODE, false, true>(p, stream);
    return full ? launch<MODE, true, false>(p, stream)
                : launch<MODE, false, false>(p, stream);
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
template <int MODE, bool FULL, bool MASKED, bool SMEM_RING>
cudaError_t stream_plan(Params& p, int cluster, int rows,
                        cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                        int* resident) {
    auto kern = ring_kernel<MODE, FULL, MASKED, SMEM_RING>;
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
        const size_t smem = smem_bytes<MODE>(p)
            + ring_smem_bytes(p, p.k, MASKED, SMEM_RING);
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

template <int MODE, bool FULL, bool MASKED, bool SMEM_RING>
cudaError_t launch_stream(Params p, int cluster, int rows, int* used,
                          cudaStream_t stream) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    int resident = 0;
    cudaError_t err = stream_plan<MODE, FULL, MASKED, SMEM_RING>(
        p, cluster, rows, cfg, attr, &resident);
    if (err != cudaSuccess) return err;
    cfg.stream = stream;
    *used = (int)attr[0].val.clusterDim.x;
    err = cudaLaunchKernelEx(
        &cfg, ring_kernel<MODE, FULL, MASKED, SMEM_RING>, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// f(mode, full, masked, smem_ring) with each as a compile-time constant:
// ring_kernel's 24 instantiations
template <typename F>
cudaError_t with_cluster_body(int mode, bool full, bool masked,
                              bool smem_ring, F&& f) {
    auto ring = [&](auto m, auto fu, auto ma) {
        return smem_ring ? f(m, fu, ma, std::true_type{})
                         : f(m, fu, ma, std::false_type{});
    };
    auto mask = [&](auto m, auto fu) {
        return masked ? ring(m, fu, std::true_type{})
                      : ring(m, fu, std::false_type{});
    };
    auto split = [&](auto m) {
        return full ? mask(m, std::true_type{}) : mask(m, std::false_type{});
    };
    switch (mode) {
        case MODE_SCORE:
            return split(std::integral_constant<int, MODE_SCORE>{});
        case MODE_REGION:
            return split(std::integral_constant<int, MODE_REGION>{});
        case MODE_PATH:
            return split(std::integral_constant<int, MODE_PATH>{});
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int wavefront_launch(
    int mode, const int32_t* plan, const int32_t* ring_row,
    const int32_t* lane_row, const int32_t* dims, const int32_t* qvecs,
    int nq, const int32_t* tvecs, int nt, const int32_t* tables, int ntab,
    const int32_t* scalars, int nsc, int32_t* ring, int32_t* lring,
    uint8_t* tb, int32_t* out, int n_plan, int B, int Qp, int Tp, int S,
    int L, int NR, int NL, int R, int n_shadow, int start_id, int end_id,
    int start_scope, int end_scope, int split, const uint8_t* blocked,
    void* stream) {
    if (B <= 0) return 0;
    if (L > MAX_L) return (int)cudaErrorInvalidValue;
    Params p{plan, ring_row, lane_row, dims, qvecs, tvecs, tables, scalars,
             ring, lring, tb, blocked, out, nq, nt, ntab, nsc, n_plan, B, Qp,
             Tp, S, L, NR, NL, R, n_shadow, start_id, end_id, start_scope,
             end_scope, 0, 0};
    cudaStream_t s = (cudaStream_t)stream;
    const bool full = split || L > LEAN_L;
    const bool masked = blocked != nullptr;
    cudaError_t err;
    switch (mode) {
        case MODE_SCORE: err = launch<MODE_SCORE>(p, full, masked, s); break;
        case MODE_REGION:
            err = launch<MODE_REGION>(p, full, masked, s);
            break;
        case MODE_PATH: err = launch<MODE_PATH>(p, full, masked, s); break;
        default: err = cudaErrorInvalidValue;
    }
    return (int)err;
}

// K2: the arguments of wavefront_launch, then the cluster size asked for
// (0: the rule of stream_plan), the batch's widest diagonal, the
// diagonals [d_begin, d_end) to run (a later segment continues the ring
// that the launch before it left), whether the carry ring lives in
// shared memory (cuda_wavefront.ring_in_smem) and, if so, its RING_LOAD /
// RING_STORE bits, and where to write the cluster size launched.  Score
// and region modes are K2; path mode (tb holding d_end - d_begin
// diagonals: a segment of the checkpointed traceback, or a masked path
// DP over all of them) is K4 on the cluster.
extern "C" int wavefront_stream_launch(
    int mode, const int32_t* plan, const int32_t* ring_row,
    const int32_t* lane_row, const int32_t* dims, const int32_t* qvecs,
    int nq, const int32_t* tvecs, int nt, const int32_t* tables, int ntab,
    const int32_t* scalars, int nsc, int32_t* ring, int32_t* lring,
    uint8_t* tb, int32_t* out, int n_plan, int B, int Qp, int Tp, int S,
    int L, int NR, int NL, int R, int n_shadow, int start_id, int end_id,
    int start_scope, int end_scope, int split, const uint8_t* blocked,
    int cluster, int rows, int d_begin, int d_end, int smem_ring,
    int ring_io, int* cluster_used, void* stream) {
    if (B <= 0) return 0;
    if (L > MAX_L || d_begin < 0 || d_end < d_begin
        || (mode == MODE_PATH) != (tb != nullptr))
        return (int)cudaErrorInvalidValue;
    Params p{plan, ring_row, lane_row, dims, qvecs, tvecs, tables, scalars,
             ring, lring, tb, blocked, out, nq, nt, ntab, nsc, n_plan, B, Qp,
             Tp, S, L, NR, NL, R, n_shadow, start_id, end_id, start_scope,
             end_scope, d_begin, d_end, 0, ring_io};
    cudaStream_t s = (cudaStream_t)stream;
    return (int)with_cluster_body(
        mode, split || L > LEAN_L, blocked != nullptr, smem_ring != 0,
        [&](auto m, auto fu, auto ma, auto sr) {
            return launch_stream<decltype(m)::value, decltype(fu)::value,
                                 decltype(ma)::value, decltype(sr)::value>(
                p, cluster, rows, cluster_used, s);
        });
}

// The cluster size K2 would launch for a batch of this model and width
// (its rule, or the size asked for), written to *cluster_used, and how
// many such clusters are resident on the card at once, to *resident:
// cuda_wavefront routes a masked batch to the cluster kernel when all of
// its pairs' clusters are.
extern "C" int wavefront_stream_capacity(
    int mode, int split, int masked, int smem_ring, int n_plan, int S,
    int L, int NR, int NL, int R, int rows, int cluster, int* cluster_used,
    int* resident) {
    if (L > MAX_L) return (int)cudaErrorInvalidValue;
    Params p{};
    p.n_plan = n_plan;
    p.B = 1;
    p.S = S;
    p.L = L;
    p.NR = NR;
    p.NL = NL;
    p.R = R;
    return (int)with_cluster_body(
        mode, split || L > LEAN_L, masked != 0, smem_ring != 0,
        [&](auto m, auto fu, auto ma, auto sr) {
            cudaLaunchAttribute attr[1];
            cudaLaunchConfig_t cfg;
            const cudaError_t err =
                stream_plan<decltype(m)::value, decltype(fu)::value,
                            decltype(ma)::value, decltype(sr)::value>(
                    p, cluster, rows, cfg, attr, resident);
            if (err == cudaSuccess)
                *cluster_used = (int)attr[0].val.clusterDim.x;
            return err;
        });
}
