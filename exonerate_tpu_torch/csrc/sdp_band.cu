// The seeded band scan of the default heuristic for a batch of
// comparisons: K6 (reverse pass) and K7 (forward pass), hand-written for
// Hopper (sm_90a).
//
// Replaces exonerate_tpu/engine/sdp_pallas.py: build_sdp_kernel (:237),
// whose make_kernel(False) is the reverse pass (pallas_call :974) and
// make_kernel(True) the forward pass (pallas_call :996).  The semantics
// are those of exonerate_tpu/engine/sdp_device.py:1-37; the plain PyTorch
// version beside this file (engine/sdp_device.py, plain_band_reverse /
// plain_band_forward) evaluates the same candidate tables.
//
// What it computes.  One CTA per comparison.  The CTA walks the
// compressed diagonals d = i + j of its comparison (reverse: from
// qlen + wlen down to 0; forward: up), and its threads own the valid
// cells of a diagonal, lanes i = lo + 32-aligned block + tid.  One
// __syncthreads() per diagonal orders the writes of a diagonal before the
// reads of the next.  Per cell:
//  - injection: reverse, the seed layers (seedq[j] - 1 == i -> the best
//    seedv, sdp_pallas.py:457-465) into the END state; forward, the
//    boundary bit of the cell into the START state (a thaw cell);
//  - the advancing candidates, in the host's (-at, -aq, rix) order, each
//    reading its source cell (i -/+ aq, j -/+ at) of diagonal d -/+ adv
//    from the carry ring, with strict > replacement (first max wins),
//    pmax lanes, the dropoff test, the forward kill of negatives and the
//    protect clamps (:549-622);
//  - forward only, the span thaw + submit of every span (:627-769)
//    BEFORE the silent sweep, so that silent exits from span states read
//    the post-thaw value;
//  - the silent candidates, reading the running values of the cell;
//  - live on _edge columns, the per-column best end score (forward), the
//    boundary flag (reverse: START >= 0 or a span state > 0), and the
//    ring store.
// Only valid cells (0 <= i <= qlen, 0 <= j <= wlen) are walked; the
// Pallas kernel's extra lanes and diagonals cannot change an output.
//
// The TPU frame is layout and is not kept: a W-axis vector is a plain
// (Wp+1) row read at column j (0 outside [0, Wp], as the Pallas frame's
// zero padding gives); the boundary plane is one bit per cell, 32 lanes
// per word by __ballot_sync, laid out [B][Dp][NW]; the column best is a
// plain (Wp+1) row.  Each column j = d - i has exactly one lane per
// diagonal and diagonals are ordered by the barrier, so the column best
// is a plain read-modify-write, deterministic without atomics.
//
// Scores are int32 and wrap as in the reference (jnp int32): sums,
// differences and the span window tests go through uint32, since signed
// overflow is undefined in C++.
//
// Joint spans (ner): the curr register moves one lane per diagonal (lane
// i reads lane i - 1's register of the previous diagonal), so the curr
// planes are double-buffered by the parity of d; the stored registers
// belong to their own lane and are single-buffered.
//
// What bounds it on the H100.  The diagonal loop: a 1 Mb comparison has
// ~60k diagonals of <= Q+1 cells, each diagonal ends in a block barrier,
// and each cell interprets ~22 candidates whose sources sit in the carry
// ring in global memory / L2 (3 diagonals x 10 states x (Qp+1) lanes, a
// few hundred KB per comparison, resident in L2).  Each thread walks its
// lanes of a diagonal in series, so the block is as wide as a block may
// be.  One CTA per comparison leaves SMs idle below 132 comparisons;
// splitting the lanes of a comparison over a cluster is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEG = -987654321;       // IMPOSSIBLY_LOW_SCORE
constexpr int32_t POS = 987654321;        // IMPOSSIBLY_HIGH_SCORE
// a multiple of 32; 1024 threads (2 lanes each of a 1281-lane diagonal)
// ran the scan's batch 1.8x faster than 256 on an H100 (PERF.md, section 5)
constexpr int THREADS = 1024;

// maxima (engine/cuda_sdp.py).  The per-thread cell state is sized by
// the state bound of the instantiation: SMALL_S (est2genome) or MAX_S
// (the split-codon models, up to cdna2genome's 22 states).
constexpr int SMALL_S = 16;
constexpr int MAX_S = 24;
constexpr int MAX_SH = 4;
constexpr int MAX_SPANS = 6;
constexpr int MAX_CAND = 64;
constexpr int MAX_SEED_LAYERS = 4;
constexpr int MAX_STARTS = 4;

// candidate-table columns (engine/sdp_device.py: BP_*)
constexpr int BP_AQ = 0;
constexpr int BP_AT = 1;
constexpr int BP_READ = 2;
constexpr int BP_WRITE = 3;
constexpr int BP_FLAGS = 4;
constexpr int BP_CALC = 5;
constexpr int BP_C0 = 6;
constexpr int BP_C1 = 7;
constexpr int BP_C2 = 8;
constexpr int BP_C3 = 9;
constexpr int BP_CONTIG = 10;
constexpr int BP_SH_LANE_Q = 11;
constexpr int BP_SH_LANE_T = 12;
constexpr int BP_SH_MIN = 13;
constexpr int BP_SH_MAX = 14;
constexpr int BP_C4 = 15;
constexpr int BP_C5 = 16;
constexpr int BP_C6 = 17;
constexpr int BP_NSTART = 18;
constexpr int BP_ST_DES0 = 19;    // start lane k: BP_ST_DES0 + 2k ...
constexpr int BP_ST_SRC0 = 20;    // ... and its source, BP_ST_SRC0 + 2k
constexpr int BP_COLS = 27;

// BP_ST_SRC codes: _abs_t or the query lane of the source cell, or
// ST_TVEC + r: tvecs row r at the source column (a shadow start vector)
constexpr int ST_TARGET = 0;
constexpr int ST_QUERY = 1;
constexpr int ST_TVEC = 2;

// BP_FLAGS bits
constexpr int BF_P_UNDER = 1;
constexpr int BF_P_OVER = 2;
constexpr int BF_EVENT = 4;
constexpr int BF_SH_Q = 8;
constexpr int BF_SH_T = 16;

// BP_CALC kinds
constexpr int K_NONE = 0;
constexpr int K_QT = 1;
constexpr int K_FACTORED = 2;
constexpr int K_SCALAR = 3;
constexpr int K_QVEC = 4;
constexpr int K_TVEC = 5;
constexpr int K_SPLIT = 6;

// span-table columns
constexpr int SP_STATE = 0;
constexpr int SP_MAX_T = 1;
constexpr int SP_MAX_Q = 2;
constexpr int SP_POST_THAW = 3;
constexpr int SP_COLS = 4;

struct Params {
    const int32_t* plan;      // (n_plan, BP_COLS): advancing, then silent
    const int32_t* spans;     // (n_spans, SP_COLS)
    const int32_t* ring_row;  // (S,)
    const int32_t* dims;      // (B, 2): qlen, wlen
    const int32_t* qvecs;     // (B, nq, Qp+1)
    const int32_t* tvecs;     // (B, nt, Wp+1)
    const int32_t* scalars;   // (B, ns)
    int32_t* bits;            // (B, Dp, NW): written by K6, read by K7
    int32_t* ring_sc;         // (B, R, NR, Qp+1)
    int32_t* ring_pm;         // (B, R, NR, Qp+1)
    int32_t* ring_ln;         // (B, R, NR * n_sh, Qp+1), forward
    int32_t* span_st;         // (B, n_spans, 4 + n_sh, Qp+1), forward
    int32_t* span_cu;         // (B, 2, n_spans, 4 + n_sh, Qp+1), forward
    int32_t* colbest;         // (B, Wp+1), forward
    int32_t* live;            // (B,)
    int32_t* xband;           // (B,), forward
    int n_plan, n_adv, n_spans, nq, nt, ns;
    int B, Qp, Wp, S, n_sh, K, NR, start_id, end_id, dropoff;
    int row_abs_t, row_edge, row_seg, row_seedq, row_seedv, n_layers;
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

// floor division by 6, as jnp's // on int32
__device__ __forceinline__ int floordiv6(int32_t x) {
    const int q = x / 6;
    return (x % 6 != 0 && x < 0) ? q - 1 : q;
}

// MS bounds the model's states: the cell state csc/cpm/cln is sized by it
template <bool FWD, int MS>
__global__ void __launch_bounds__(THREADS) band_kernel(const Params p) {
    __shared__ int32_t s_plan[MAX_CAND * BP_COLS];
    __shared__ int32_t s_span[MAX_SPANS * SP_COLS];
    __shared__ int32_t s_ring[MAX_S];
    const int tid = threadIdx.x;
    const int b = blockIdx.x;
    for (int k = tid; k < p.n_plan * BP_COLS; k += THREADS)
        s_plan[k] = p.plan[k];
    for (int k = tid; k < p.n_spans * SP_COLS; k += THREADS)
        s_span[k] = p.spans[k];
    for (int k = tid; k < p.S; k += THREADS) s_ring[k] = p.ring_row[k];
    __syncthreads();

    const int W = p.Qp + 1, WT = p.Wp + 1, R = p.K + 1;
    const int Dp = p.Qp + p.Wp + 1, NW = (p.Qp + 32) / 32;
    const int S = p.S, n_sh = p.n_sh, NR = p.NR, NL = NR * n_sh;
    const int NSR = 4 + n_sh;
    const int qlen = p.dims[b * 2 + 0], wlen = p.dims[b * 2 + 1];
    const int32_t* qv = p.qvecs + (size_t)b * p.nq * W;
    const int32_t* tv = p.tvecs + (size_t)b * p.nt * WT;
    const int32_t* scl = p.scalars + (size_t)b * p.ns;
    int32_t* rsc = p.ring_sc + (size_t)b * R * NR * W;
    int32_t* rpm = p.ring_pm + (size_t)b * R * NR * W;
    int32_t* rln = FWD && NL ? p.ring_ln + (size_t)b * R * NL * W : nullptr;
    int32_t* bits = p.bits + (size_t)b * Dp * NW;
    int32_t* st_reg = FWD ? p.span_st + (size_t)b * p.n_spans * NSR * W
                          : nullptr;
    int32_t* colbest = FWD ? p.colbest + (size_t)b * WT : nullptr;

    // a W-axis vector at column c (0 outside [0, Wp]) and a q-axis vector
    // at lane l (0 outside [0, Qp])
    auto tcol = [&](int row, int c) -> int32_t {
        return (c >= 0 && c <= p.Wp) ? tv[(size_t)row * WT + c] : 0;
    };
    auto qlane = [&](int row, int l) -> int32_t {
        return (l >= 0 && l <= p.Qp) ? qv[(size_t)row * W + l] : 0;
    };

    bool any_live = false, any_xband = false;
    int32_t csc[MS], cpm[MS], cln[MS * MAX_SH];

    const int n_diag = qlen + wlen + 1;
    for (int step = 0; step < n_diag; ++step) {
        const int d = FWD ? step : n_diag - 1 - step;
        const int lo = d - wlen > 0 ? d - wlen : 0;
        const int hi = d < qlen ? d : qlen;
        const int slot = d % R;
        int32_t* cu_prev = FWD
            ? p.span_cu + ((size_t)(b * 2 + ((d + 1) & 1)) * p.n_spans) * NSR
                  * W
            : nullptr;
        int32_t* cu_cur = FWD
            ? p.span_cu + ((size_t)(b * 2 + (d & 1)) * p.n_spans) * NSR * W
            : nullptr;
        for (int i0 = lo & ~31; i0 <= hi; i0 += THREADS) {
            const int i = i0 + tid;
            const bool act = i >= lo && i <= hi;
            bool flag = false;
            if (act) {
                const int j = d - i;
                for (int s = 0; s < S; ++s) {
                    csc[s] = NEG;
                    cpm[s] = NEG;
                    if (FWD)
                        for (int l = 0; l < n_sh; ++l) cln[s * MAX_SH + l] = 0;
                }
                bool thaw = false;
                if (FWD) {
                    const uint32_t w =
                        (uint32_t)bits[(size_t)d * NW + (i >> 5)];
                    thaw = (w >> (i & 31)) & 1u;
                    if (thaw) {
                        csc[p.start_id] = 0;
                        cpm[p.start_id] = 0;
                    }
                } else {
                    int32_t r = NEG;
                    for (int lx = 0; lx < p.n_layers; ++lx)
                        if (tcol(p.row_seedq + lx, j) - 1 == i) {
                            const int32_t v = tcol(p.row_seedv + lx, j);
                            r = v > r ? v : r;
                        }
                    csc[p.end_id] = r;
                    cpm[p.end_id] = r;
                }
                int32_t ev = NEG;

                auto candidate = [&](int c) {
                    const int32_t* row = s_plan + c * BP_COLS;
                    const int aq = row[BP_AQ], at = row[BP_AT];
                    const int adv = aq + at, r = row[BP_READ];
                    const int si = FWD ? i - aq : i + aq;
                    const int sj = FWD ? j - at : j + at;
                    if (si < 0 || si > qlen || sj < 0 || sj > wlen) return;
                    if (at && tcol(row[BP_CONTIG], FWD ? j : j + at) == 0)
                        return;
                    int32_t s_sc, s_pm;
                    int32_t s_ln[MAX_SH];
                    if (adv == 0) {
                        s_sc = csc[r];
                        s_pm = cpm[r];
                        if (FWD)
                            for (int l = 0; l < n_sh; ++l)
                                s_ln[l] = cln[r * MAX_SH + l];
                    } else {
                        const int sd = FWD ? d - adv : d + adv;
                        const int rr = s_ring[r];
                        const size_t at_ix =
                            ((size_t)(sd % R) * NR + rr) * W + si;
                        s_sc = rsc[at_ix];
                        s_pm = rpm[at_ix];
                        if (FWD)
                            for (int l = 0; l < n_sh; ++l)
                                s_ln[l] = rln[((size_t)(sd % R) * NL
                                               + rr * n_sh + l) * W + si];
                    }
                    if (s_sc <= NEG) return;
                    const int qi = FWD ? i - aq : i;
                    const int tj = FWD ? j - at : j;
                    bool has = true;
                    int32_t tsc = 0;
                    switch (row[BP_CALC]) {
                        case K_QT:
                            tsc = wadd(qlane(row[BP_C0], qi),
                                       tcol(row[BP_C1], tj));
                            break;
                        case K_FACTORED: {
                            const int cls = tcol(row[BP_C1], tj);
                            tsc = (cls >= 0 && cls < row[BP_C3])
                                ? qlane(row[BP_C0] + cls, qi) : 0;
                            if (row[BP_C2] >= 0) {
                                const int32_t ov = qlane(row[BP_C2], qi);
                                if (ov != 0) tsc = ov;
                            }
                            break;
                        }
                        case K_SCALAR: tsc = scl[row[BP_C0]]; break;
                        case K_QVEC: tsc = qlane(row[BP_C0], qi); break;
                        case K_TVEC: tsc = tcol(row[BP_C1], tj); break;
                        case K_SPLIT: {
                            // kernel K9 (model/phase.py:305-327): the aa of
                            // a codon split by an intron, decoded from the
                            // packed lanes, indexes the 25 query rows
                            // R0..R24 (pre-shifted by aq: read at lane i)
                            const int phase = row[BP_C2];
                            if (!(s_ln[row[BP_C3]] >= phase)) {
                                tsc = NEG;
                                break;
                            }
                            int32_t sel, sub = 0;
                            if (phase == 1) {
                                sel = s_ln[row[BP_C4]];
                                const int k = floordiv6(sel);
                                if (k >= 0 && k < 3)
                                    sub = tcol(row[BP_C1] + k, tj);
                            } else {
                                sel = tcol(row[BP_C1], tj);
                                const int k = floordiv6(sel);
                                if (k >= 0 && k < 3)
                                    sub = s_ln[row[k == 0 ? BP_C4
                                                   : k == 1 ? BP_C5 : BP_C6]];
                            }
                            int field = sel % 6;
                            if (field < 0) field += 6;
                            const int aa = (sub >> (5 * field)) & 31;
                            tsc = aa < 25 ? qlane(row[BP_C0] + aa, i) : 0;
                            break;
                        }
                        case K_NONE: default: has = false; break;
                    }
                    const int flags = row[BP_FLAGS];
                    if (FWD && (flags & (BF_SH_Q | BF_SH_T))) {
                        // intron length window (model/intron.py:140-149)
                        const int32_t mn = scl[row[BP_SH_MIN]];
                        const int32_t mx = scl[row[BP_SH_MAX]];
                        bool bad = false;
                        if (flags & BF_SH_Q) {
                            const int32_t len = wadd(
                                wsub(i - aq, s_ln[row[BP_SH_LANE_Q]]), 2);
                            bad = bad || len < mn || len > mx;
                        }
                        if (flags & BF_SH_T) {
                            const int32_t len = wadd(
                                wsub(tcol(p.row_abs_t, j - at),
                                     s_ln[row[BP_SH_LANE_T]]), 2);
                            bad = bad || len < mn || len > mx;
                        }
                        if (bad) tsc = NEG;
                    }
                    int32_t val = has ? wadd(s_sc, tsc) : s_sc;
                    if ((flags & BF_P_UNDER) && val < NEG) val = NEG;
                    if ((flags & BF_P_OVER) && val > POS) val = POS;
                    if (FWD && val < 0) return;
                    if (wsub(s_pm, val) > p.dropoff) return;
                    const int w = row[BP_WRITE];
                    if (!(val > csc[w])) return;        // first max wins
                    csc[w] = val;
                    cpm[w] = s_pm > val ? s_pm : val;
                    if (FWD && n_sh) {
                        const int n_start = row[BP_NSTART] < MAX_STARTS
                            ? row[BP_NSTART] : MAX_STARTS;
                        for (int k = 0; k < n_start; ++k) {
                            const int src = row[BP_ST_SRC0 + 2 * k];
                            s_ln[row[BP_ST_DES0 + 2 * k]] =
                                src == ST_TARGET ? tcol(p.row_abs_t, j - at)
                                : src == ST_QUERY ? i - aq
                                : tcol(src - ST_TVEC, j - at);
                        }
                        for (int l = 0; l < n_sh; ++l)
                            cln[w * MAX_SH + l] = s_ln[l];
                    }
                    if (FWD && (flags & BF_EVENT) && val >= s_pm) ev = val;
                };

                for (int c = 0; c < p.n_adv; ++c) candidate(c);

                if (FWD && p.n_spans) {
                    // span thaw + submit, before the silent sweep
                    const int32_t abs_tv = tcol(p.row_abs_t, j);
                    const int32_t seg = tcol(p.row_seg, j);
                    for (int spx = 0; spx < p.n_spans; ++spx) {
                        const int32_t* sp = s_span + spx * SP_COLS;
                        const int st = sp[SP_STATE];
                        const int32_t max_t = sp[SP_MAX_T];
                        if (max_t == 0) continue;   // query-only: no-op
                        int32_t* str = st_reg + (size_t)spx * NSR * W;
                        int32_t* cp = cu_prev + (size_t)spx * NSR * W;
                        int32_t* cc = cu_cur + (size_t)spx * NSR * W;
                        int32_t st_sc = str[0 * W + i], st_pm = str[W + i];
                        int32_t st_te = str[2 * W + i];
                        int32_t st_sg = str[3 * W + i];
                        int32_t st_ln[MAX_SH], cu_ln[MAX_SH];
                        for (int l = 0; l < n_sh; ++l)
                            st_ln[l] = str[(4 + l) * W + i];
                        const bool joint = sp[SP_MAX_Q] > 0;
                        // joint: lane i - 1 of the previous diagonal
                        // (fill at lane 0); target-only: own lane
                        const int src = joint ? i - 1 : i;
                        int32_t cu_sc = NEG, cu_pm = 0, cu_te = 0, cu_sg = 0;
                        for (int l = 0; l < n_sh; ++l) cu_ln[l] = 0;
                        if (src >= 0) {
                            cu_sc = cp[0 * W + src];
                            cu_pm = cp[1 * W + src];
                            cu_te = cp[2 * W + src];
                            cu_sg = cp[3 * W + src];
                            for (int l = 0; l < n_sh; ++l)
                                cu_ln[l] = cp[(4 + l) * W + src];
                        }
                        bool upd;
                        if (joint) {
                            const bool r_ok = cu_sc > NEG
                                && wadd(cu_te, max_t) >= abs_tv;
                            const bool st_ok = st_sc > NEG
                                && wadd(st_te, max_t) >= abs_tv;
                            upd = thaw && st_ok && (!r_ok || cu_sc < st_sc);
                            cu_sc = upd ? st_sc : (r_ok ? cu_sc : NEG);
                        } else {
                            const bool in_w = wadd(st_te, max_t) >= abs_tv;
                            if (thaw && st_sc > NEG && !in_w) st_sc = NEG;
                            const bool cu_ok = cu_sc > NEG
                                && wadd(cu_te, max_t) >= abs_tv;
                            upd = thaw && st_sc > NEG && in_w
                                && (!cu_ok || cu_sc < st_sc);
                            if (upd) cu_sc = st_sc;
                            else if (thaw && !cu_ok) cu_sc = NEG;
                        }
                        if (upd) {
                            cu_pm = st_pm;
                            cu_te = st_te;
                            cu_sg = st_sg;
                            for (int l = 0; l < n_sh; ++l) cu_ln[l] = st_ln[l];
                        }
                        const bool th = thaw && cu_sc > NEG && csc[st] < cu_sc;
                        if (th && cu_sg != seg) any_xband = true;
                        int32_t sub_sc = csc[st], sub_pm = cpm[st];
                        int32_t sub_ln[MAX_SH];
                        for (int l = 0; l < n_sh; ++l)
                            sub_ln[l] = cln[st * MAX_SH + l];
                        if (th) {
                            csc[st] = cu_sc;
                            cpm[st] = cu_pm;
                            for (int l = 0; l < n_sh; ++l)
                                cln[st * MAX_SH + l] = cu_ln[l];
                            if (sp[SP_POST_THAW]) {
                                sub_sc = cu_sc;
                                sub_pm = cu_pm;
                                for (int l = 0; l < n_sh; ++l)
                                    sub_ln[l] = cu_ln[l];
                            }
                        }
                        if (sub_sc >= 0 && sub_sc >= st_sc) {
                            st_sc = sub_sc;
                            st_pm = sub_pm;
                            st_te = abs_tv;
                            st_sg = seg;
                            for (int l = 0; l < n_sh; ++l) st_ln[l] = sub_ln[l];
                        }
                        str[0 * W + i] = st_sc;
                        str[1 * W + i] = st_pm;
                        str[2 * W + i] = st_te;
                        str[3 * W + i] = st_sg;
                        cc[0 * W + i] = cu_sc;
                        cc[1 * W + i] = cu_pm;
                        cc[2 * W + i] = cu_te;
                        cc[3 * W + i] = cu_sg;
                        for (int l = 0; l < n_sh; ++l) {
                            str[(4 + l) * W + i] = st_ln[l];
                            cc[(4 + l) * W + i] = cu_ln[l];
                        }
                    }
                }

                for (int c = p.n_adv; c < p.n_plan; ++c) candidate(c);

                bool live_cell = false;
                for (int s = 0; s < S; ++s) live_cell |= csc[s] > NEG;
                if (live_cell && tcol(p.row_edge, j) != 0) any_live = true;
                if (FWD) {
                    if (ev > NEG && ev > colbest[j]) colbest[j] = ev;
                } else {
                    flag = csc[p.start_id] >= 0;
                    for (int spx = 0; spx < p.n_spans; ++spx)
                        flag |= csc[s_span[spx * SP_COLS + SP_STATE]] > 0;
                }
                for (int s = 0; s < S; ++s) {
                    const int rr = s_ring[s];
                    if (rr < 0) continue;
                    const size_t ix = ((size_t)slot * NR + rr) * W + i;
                    rsc[ix] = csc[s];
                    rpm[ix] = cpm[s];
                    if (FWD)
                        for (int l = 0; l < n_sh; ++l)
                            rln[((size_t)slot * NL + rr * n_sh + l) * W + i] =
                                cln[s * MAX_SH + l];
                }
            }
            if (!FWD) {
                // 32 lanes per word; the block starts 32-aligned
                const unsigned word = __ballot_sync(0xffffffffu, flag);
                if ((tid & 31) == 0 && (i >> 5) < NW)
                    bits[(size_t)d * NW + (i >> 5)] = (int32_t)word;
            }
        }
        __syncthreads();
    }
    const int live = __syncthreads_or(any_live);
    if (FWD) {
        const int xb = __syncthreads_or(any_xband);
        if (tid == 0) p.xband[b] = xb ? 1 : 0;
    }
    if (tid == 0) p.live[b] = live ? 1 : 0;
}

template <bool FWD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    if (p.S <= SMALL_S)
        band_kernel<FWD, SMALL_S><<<p.B, THREADS, 0, stream>>>(p);
    else
        band_kernel<FWD, MAX_S><<<p.B, THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}

int check(const Params& p) {
    if (p.n_plan > MAX_CAND || p.n_adv > p.n_plan || p.S > MAX_S
        || p.n_sh > MAX_SH || p.n_spans > MAX_SPANS
        || p.n_layers > MAX_SEED_LAYERS || p.K < 1)
        return (int)cudaErrorInvalidValue;
    return 0;
}

}  // namespace

#define SDP_BAND_ARGS                                                        \
    const int32_t *plan, const int32_t *spans, const int32_t *ring_row,     \
        const int32_t *dims, const int32_t *qvecs, const int32_t *tvecs,    \
        const int32_t *scalars, int32_t *bits, int32_t *ring_sc,            \
        int32_t *ring_pm, int32_t *ring_ln, int32_t *span_st,               \
        int32_t *span_cu, int32_t *colbest, int32_t *live, int32_t *xband,  \
        int n_plan, int n_adv, int n_spans, int nq, int nt, int ns, int B,  \
        int Qp, int Wp, int S, int n_sh, int K, int NR, int start_id,       \
        int end_id, int dropoff, int row_abs_t, int row_edge, int row_seg,  \
        int row_seedq, int row_seedv, int n_layers, void *stream

#define SDP_BAND_PARAMS                                                      \
    Params p{plan, spans, ring_row, dims, qvecs, tvecs, scalars, bits,      \
             ring_sc, ring_pm, ring_ln, span_st, span_cu, colbest, live,    \
             xband, n_plan, n_adv, n_spans, nq, nt, ns, B, Qp, Wp, S, n_sh, \
             K, NR, start_id, end_id, dropoff, row_abs_t, row_edge,         \
             row_seg, row_seedq, row_seedv, n_layers}

// K6: the reverse pass.  Writes bits and live.
extern "C" int sdp_band_reverse(SDP_BAND_ARGS) {
    if (B <= 0) return 0;
    SDP_BAND_PARAMS;
    const int bad = check(p);
    if (bad) return bad;
    return (int)launch<false>(p, (cudaStream_t)stream);
}

// K7: the forward pass from K6's bits.  Writes colbest, live and xband;
// span_st / span_cu come initialised (sc rows NEG, the rest 0).
extern "C" int sdp_band_forward(SDP_BAND_ARGS) {
    if (B <= 0) return 0;
    SDP_BAND_PARAMS;
    const int bad = check(p);
    if (bad) return bad;
    return (int)launch<true>(p, (cudaStream_t)stream);
}
