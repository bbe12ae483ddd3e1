// Exhaustive anti-diagonal Viterbi for a batch of pairs: K1 (score and
// region modes) and K4 (path mode), hand-written for Hopper (sm_90a).
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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEG = -987654321;       // IMPOSSIBLY_LOW_SCORE
constexpr int32_t HIGH = 987654321;       // IMPOSSIBLY_HIGH_SCORE
constexpr int THREADS = 256;              // a power of two (final reduce)
constexpr int MAX_L = 4;                  // lanes per state (cuda_wavefront)

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
constexpr int P_NSTART = 15;
constexpr int P_ST_DES0 = 16;
constexpr int P_ST_ONQ0 = 17;
constexpr int PLAN_COLS = 20;

// P_FLAGS bits
constexpr int F_FROM_START = 1;
constexpr int F_TO_END = 2;
constexpr int F_P_UNDER = 4;
constexpr int F_P_OVER = 8;
constexpr int F_SH_Q = 16;
constexpr int F_SH_T = 32;

// P_CALC kinds
constexpr int C_NONE = 0;
constexpr int C_SCALAR = 1;
constexpr int C_QVEC = 2;
constexpr int C_TVEC = 3;
constexpr int C_FACTORED = 4;

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
    int32_t* out;               // (5, B)
    int nq, nt, ntab, nsc;
    int n_plan, B, Qp, Tp, S, L, NR, NL, R, n_shadow;
    int start_id, end_id, start_scope, end_scope;
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

template <int MODE>
__global__ void __launch_bounds__(THREADS)
wavefront_kernel(const Params p) {
    extern __shared__ int32_t smem[];
    const int tid = threadIdx.x;
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

    int32_t best_s = NEG, best_j = INT32_MAX, best_i = INT32_MAX;
    int32_t best_qs = 0, best_ts = 0;

    const int n_diag = qlen + tlen + 1;
    for (int d = 0; d < n_diag; ++d) {
        const int lo = d - tlen > 0 ? d - tlen : 0;
        const int hi = d < qlen ? d : qlen;
        const int slot = d % R;
        for (int i = lo + tid; i <= hi; i += THREADS) {
            const int j = d - i;
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
                    int32_t nl[MAX_L];
                    for (int l = 0; l < L; ++l) nl[l] = src_lane(l);
                    for (int k = 0; k < row[P_NSTART]; ++k)
                        nl[row[P_ST_DES0 + 2 * k]] =
                            row[P_ST_ONQ0 + 2 * k] ? si + qstart : sj + tstart;
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
                if (MODE == MODE_PATH)
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
    if (tid == 0) {
        const bool found = r_s[0] > NEG;
        p.out[0 * p.B + b] = found ? r_s[0] : NEG;
        p.out[1 * p.B + b] = found ? r_i[0] : 0;
        p.out[2 * p.B + b] = found ? r_j[0] : 0;
        p.out[3 * p.B + b] = found ? r_qs[0] : 0;
        p.out[4 * p.B + b] = found ? r_ts[0] : 0;
    }
}

template <int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    const int lanes = p.L > 0 ? p.L : 1;
    int cell_vars = p.S + p.S * p.L + (MODE == MODE_PATH ? p.S : 0);
    if (cell_vars < 5) cell_vars = 5;   // the final reduce reuses it
    const size_t smem = sizeof(int32_t)
        * ((size_t)p.n_plan * PLAN_COLS + p.S + (size_t)p.S * lanes
           + (size_t)cell_vars * THREADS);
    cudaError_t err = cudaFuncSetAttribute(
        wavefront_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    wavefront_kernel<MODE><<<p.B, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" int wavefront_launch(
    int mode, const int32_t* plan, const int32_t* ring_row,
    const int32_t* lane_row, const int32_t* dims, const int32_t* qvecs,
    int nq, const int32_t* tvecs, int nt, const int32_t* tables, int ntab,
    const int32_t* scalars, int nsc, int32_t* ring, int32_t* lring,
    uint8_t* tb, int32_t* out, int n_plan, int B, int Qp, int Tp, int S,
    int L, int NR, int NL, int R, int n_shadow, int start_id, int end_id,
    int start_scope, int end_scope, void* stream) {
    if (B <= 0) return 0;
    if (L > MAX_L) return (int)cudaErrorInvalidValue;
    Params p{plan, ring_row, lane_row, dims, qvecs, tvecs, tables, scalars,
             ring, lring, tb, out, nq, nt, ntab, nsc, n_plan, B, Qp, Tp, S,
             L, NR, NL, R, n_shadow, start_id, end_id, start_scope,
             end_scope};
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    switch (mode) {
        case MODE_SCORE: err = launch<MODE_SCORE>(p, s); break;
        case MODE_REGION: err = launch<MODE_REGION>(p, s); break;
        case MODE_PATH: err = launch<MODE_PATH>(p, s); break;
        default: err = cudaErrorInvalidValue;
    }
    return (int)err;
}
