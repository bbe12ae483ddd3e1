// The seeded band scan of the default heuristic for a batch of
// comparisons: K6 (reverse pass) and K7 (forward pass), hand-written for
// Hopper (sm_90a), each on the model's plan compiled in.
//
// Replaces exonerate_tpu/engine/sdp_pallas.py: build_sdp_kernel (:237),
// whose make_kernel(False) is the reverse pass (pallas_call :974) and
// make_kernel(True) the forward pass (pallas_call :996).  The semantics
// are those of exonerate_tpu/engine/sdp_device.py:1-37; the plain PyTorch
// version beside this file (engine/sdp_device.py, plain_band_reverse /
// plain_band_forward) evaluates the same candidate tables.
//
// The plan.  Built once per model plan (_cudabuild.load(stem, header),
// COMPILED_PLAN): plan.h, generated by engine/plan_cuda.py, holds both
// passes' candidate tables, the span table (its windows, set by
// --maxintron, only as whether a span has one) and the ring maps as
// constexpr data (struct BandPlan), and band_kernel unrolls every loop over
// candidates, states, spans and lanes in plan order, as the Pallas kernel
// unrolls its plan while tracing (sdp_pallas.py:624, :771).  Each
// candidate's read and write states, calc kind, rows and ring row are
// constants, so the cell state (S scores, S pmax, S x n_sh lanes) is
// registers and no table is read at run time.  What stays run-time data
// is per comparison or per run: dims, the q-axis and W-axis vectors,
// scalars, the seed layers, the dropoff and the spans' windows.
//
// What it computes.  One comparison per thread-block cluster of C CTAs
// (grid B x C).  The lanes i of the comparison are split among the CTAs:
// rank r owns [r*LB, (r+1)*LB), LB = k * blockDim (a multiple of 32, so
// a warp's boundary word lies in one CTA), and thread tid the lanes
// r*LB + tid + m*blockDim, m < k, for the whole launch.  The cluster
// walks the compressed diagonals d = i + j of its comparison (reverse:
// from qlen + wlen down to 0; forward: up), a cluster barrier per
// diagonal ordering the writes of a diagonal before the reads of the
// next.  Per cell:
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
// A non-boundary model (ungapped, affine, protein2dna, coding2coding:
// the plan's TRACK_SID) runs the semantics of the JAX package's XLA scan
// with track_sid (exonerate_tpu/engine/sdp_device.py:297, use_boundary
// false), which its Pallas kernel refuses (sdp_pallas.py:77).  K6 keeps
// a seed id per state beside the score and pmax, in registers and in
// the carry ring (one more ring row per ring state, in shared memory and
// in the halo copy, or in global memory): the END state injected at a
// seed cell takes the largest seed index of the seeds there, whatever
// their half scores (sdp_device.py:408-413); an accepted candidate
// copies its source's id (:470); a START event overwrites the cell's
// (event score, id) in candidate order (:486-490), and each cell's event
// raises start[b][id] (:701-705).  K6 writes no boundary bits.  K7
// seeds its START state at each seed's cell with start[b][k] minus the
// seed's half score, for the seeds whose start score is set, the largest
// where several share the cell (:384-397), and has no thaw cells.  The
// per-seed maximum is an atomicMax on the score alone, keyed by the
// seed: exact in any order, as nothing rides along.  Each thread keeps
// the running maximum of its last seed id in registers and flushes it to
// global memory when its cells' events move to another seed and at the
// end (a thread's lanes mostly see one seed's band, so this takes the
// atomics off the per-cell path); no shared-memory stage.
//
// The carry ring (SMEM_RING, where band_fit says it fits): each CTA
// keeps R = K + 1 slots (slot d % R) of its lanes' ring rows in shared
// memory, sc, pm and forward the lanes of each ring state, laid out
// [slot][row][lane] with H halo lanes, H the pass's largest query
// advance: below the CTA's first lane forward (sources at i - aq), above
// its last in reverse (i + aq).  At the start of each diagonal the warp
// whose lanes read the halo copies the neighbour CTA's H edge lanes of
// the diagonal before through distributed shared memory, so every source
// read is a load from the CTA's own shared memory.  The span registers
// live there too: the stored registers by own lane, the curr registers
// in two parity buffers of d with one halo lane below the first, filled
// in the same copy from the neighbour's last lane (a joint span's curr
// register moves one lane per diagonal, lane i reading lane i - 1's of
// the diagonal before).  Why one cluster barrier per diagonal suffices:
// at diagonal d a CTA writes slot d % R and parity d & 1 of its own
// lanes and reads slots d -/+ adv (adv <= K < R) and parity (d + 1) & 1;
// the copy reads the neighbour's slot of d -/+ 1, written before the
// barrier that ended that diagonal and rewritten no earlier than R
// diagonals on.  Where the ring does not fit (SMEM_RING false) the same
// kernel keeps it and the span registers in global memory, read past L1
// (__ldcg) as the other CTAs of the cluster write them.
//
// The TPU frame is layout and is not kept: a W-axis vector is a plain
// (Wp+1) row read at column j (0 outside [0, Wp], as the Pallas frame's
// zero padding gives); the boundary plane is one bit per cell, 32 lanes
// per word by __ballot_sync, laid out [B][Dp][NW]; the column best is a
// plain (Wp+1) row in global memory.  Each column j = d - i has exactly
// one lane per diagonal, lane i + 1 at d + 1 after lane i at d, possibly
// in the next CTA: the cluster barrier's release / acquire orders those
// global writes, and the read bypasses L1, so the read-modify-write is
// deterministic without atomics.  live and xband are each CTA's block
// OR, then rank 0's OR of the cluster's through distributed shared
// memory.
//
// Scores are int32 and wrap as in the reference (jnp int32): sums,
// differences and the span window tests go through uint32, since signed
// overflow is undefined in C++.
//
// K8, the cross-chip band scan (sdp_pallas.py:237 with cross=True,
// pallas_call :904 / :929, driven by run_kernel_cross_chip :1220), is the
// CROSS instantiation of the same passes: one comparison whose compressed
// W axis the host has cut into chunks, one launch per chunk and pass, the
// chunks chained through a halo (struct Halo).  A source column sj < 0
// (forward) or sj > wlen (reverse) lies up to MAXAT columns inside the
// neighbouring chunk: its carry values come from the neighbour's edge
// planes (plane k - 1 holds column -k, resp. wlen + k, indexed by the
// source lane), and such a source is valid.  After its silent sweep each
// cell of the chunk's edge columns (forward: the last MAXAT, reverse: the
// first MAXAT) writes its ring states' values to the outgoing edge plane;
// a column has one lane per diagonal, so this is a plain write, as the
// column best is.  W-axis vectors are read at columns down to -MAXAT from
// a small context array (tctx; the columns past wlen are in the row).
// The span registers are chained by the wrapper: it seeds span_st and
// both span_cu buffers from the left chunk's registers and reads each
// lane's curr register from the buffer its last cell wrote; a launch
// with the registers in shared memory loads them first and stores them
// back last.
//
// What bounds it on the H100.  Not the bytes: one cell's chain of
// dependent work per thread per diagonal, and the cluster barrier.  A
// 1 Mb comparison has ~60k diagonals of <= Q+1 cells.  The design puts
// the lanes of one comparison on C SMs (as many as the batch leaves:
// band_fit), keeps the cell state in registers and the ring in shared
// memory, and compiles the plan in, so that a cell's chain is its
// candidates' arithmetic and its calcs' vector loads.
#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <initializer_list>
#ifdef COMPILED_PLAN
#include <utility>

#include "plan.h"   // struct BandPlan: the model's plan (plan_cuda.py)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int32_t NEG = -987654321;       // IMPOSSIBLY_LOW_SCORE
constexpr int32_t POS = 987654321;        // IMPOSSIBLY_HIGH_SCORE
constexpr int MAX_CLUSTER = 16;           // CTAs per comparison, non-portable
constexpr int PORTABLE_CLUSTER = 8;       // ... without that attribute
constexpr size_t MAX_SMEM = 232448;       // dynamic shared memory of a CTA
constexpr size_t RED_BYTES = 16;          // live / xband of a CTA

// maxima (engine/cuda_sdp.py)
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

// The shared memory of a CTA over `lanes` lanes with the carry ring in
// shared memory: R slots of the pass's ring rows (sc and pm of each of
// its NR ring states and, forward, their n_sh lanes) over the lanes and
// the H halo lanes next to them; forward, each span's 4 + n_sh stored
// registers over the lanes and its curr registers in two parity buffers
// over the lanes and one halo lane.  (RED_BYTES, the block's live and
// xband, come on top in either route.)
// A non-boundary model's reverse pass (sid) carries a seed-id row per
// ring state beside sc and pm.
size_t band_smem_bytes(int fwd, int R, int NR, int n_sh, int n_spans,
                       int H, int lanes, int sid = 0) {
    const size_t nrl = (size_t)NR * (2 + (fwd ? n_sh : sid));
    const size_t nsr = 4 + (size_t)n_sh;
    return sizeof(int32_t)
        * ((size_t)R * nrl * (lanes + H)
           + (fwd ? (size_t)n_spans * nsr * (lanes + 2 * ((size_t)lanes + 1))
                  : 0));
}

// A pass's threads per CTA at most: as many as the register file (65,536
// a SM) holds at its cell state (S scores and pmax, forward S x n_sh
// lanes and a candidate's source lanes, a non-boundary reverse pass's S
// seed ids, a source's and the event's) beside ~48 registers of
// addressing and loop state.
constexpr int band_tmax(int fwd, int S, int n_sh, int sid = 0) {
    const int regs = 2 * S + (fwd ? (S + 2) * n_sh : 0)
        + (sid ? S + 2 : 0) + 48;
    return regs <= 64 ? 1024 : regs <= 128 ? 512 : 256;
}

// A band launch's cluster: C CTAs per comparison of T threads (a multiple
// of 32), k lanes per thread, and whether the carry ring lives in shared
// memory (smem: the dynamic shared memory then, RED_BYTES on top).
struct BandFit {
    int C, T, k, smem_ring;
    size_t smem;
};

// The fit rule of a pass over B comparisons whose widest has `rows` lanes
// (its qlen + 1), on a card of `sms` SMs admitting clusters of up to
// `cmax` CTAs, the pass's threads per CTA at most `tmax` (its register
// budget): the clusters of the batch side by side, C = sms / B CTAs each
// (1 to cmax, no more than the lanes' warps), T = the lanes / C rounded up
// to a warp, so that each thread owns one lane; past tmax, T = tmax and
// C = ceil(rows / T) up to cmax, k = ceil(rows / (C * T)).  The ring is
// in shared memory when band_smem_bytes of the CTA's k * T lanes fits.
BandFit band_fit(int fwd, int rows, int B, int sms, int cmax, int tmax,
                 int R, int NR, int n_sh, int n_spans, int H, int sid = 0) {
    if (rows < 1) rows = 1;
    int C = sms / (B > 0 ? B : 1);
    if (C > cmax) C = cmax;
    if (C > (rows + 31) / 32) C = (rows + 31) / 32;
    if (C < 1) C = 1;
    int T = ((rows + C - 1) / C + 31) / 32 * 32;
    if (T > tmax) {
        T = tmax;
        C = (rows + T - 1) / T;
        if (C > cmax) C = cmax;
    }
    BandFit f{};
    f.C = C;
    f.T = T;
    f.k = (rows + C * T - 1) / (C * T);
    const size_t ring = band_smem_bytes(fwd, R, NR, n_sh, n_spans, H,
                                        f.k * T, sid);
    f.smem_ring = ring + RED_BYTES <= MAX_SMEM;
    f.smem = (f.smem_ring ? ring : 0) + RED_BYTES;
    return f;
}

struct Params {
    const int32_t* spans;     // (n_spans, SP_COLS): the windows of the run
    const int32_t* dims;      // (B, 2): qlen, wlen
    const int32_t* qvecs;     // (B, nq, Qp+1)
    const int32_t* tvecs;     // (B, nt, Wp+1)
    const int32_t* scalars;   // (B, ns)
    int32_t* bits;            // (B, Dp, NW): written by K6, read by K7
    int32_t* ring_sc;         // (B, R, NR, Qp+1), global ring only
    int32_t* ring_pm;         // (B, R, NR, Qp+1), global ring only
    int32_t* ring_ln;         // (B, R, NR * n_sh, Qp+1), forward; (B, R,
                              //   NR, Qp+1) seed ids, non-boundary reverse
    int32_t* span_st;         // (B, n_spans, 4 + n_sh, Qp+1), forward
    int32_t* span_cu;         // (B, 2, n_spans, 4 + n_sh, Qp+1), forward
    int32_t* colbest;         // (B, Wp+1), forward
    int32_t* live;            // (B,)
    int32_t* xband;           // (B,), forward
    int32_t* start;           // (B, n_seed): non-boundary only, raised by
                              //   K6 (NEG-filled by the wrapper), read by K7
    int nq, nt, ns, B, Qp, Wp, dropoff;
    int row_seedq, row_seedv, n_layers;
    int row_seedi, row_seedh, n_seed;   // non-boundary: the seed-id rows
    int k;                    // lanes per thread (BandFit::k)
};

// K8's halo (CROSS only; zero for K6/K7).  B is 1.
struct Halo {
    const int32_t* tctx;      // (B, nt, maxat): W-axis rows at columns -k
    const int32_t* sc_in;     // (NR, maxat, Qp+1): the neighbour's edge
    const int32_t* pm_in;     //   columns, plane k - 1 for column -k (fwd)
    const int32_t* ln_in;     //   or wlen + k (rev); lanes (NR * n_sh, ...)
    int32_t* sc_out;          // (NR, maxat, Qp+1): this chunk's edge
    int32_t* pm_out;          //   columns, plane k - 1 for column wlen+1-k
    int32_t* ln_out;          //   (fwd) or k - 1 (rev)
    int maxat;
};

#ifdef COMPILED_PLAN
using BP = BandPlan;

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

// one pass's numbers, from the plan
template <bool FWD>
struct Pass {
    static constexpr int N = FWD ? BP::N_FWD : BP::N_REV;
    static constexpr int N_ADV = FWD ? BP::N_ADV_FWD : BP::N_ADV_REV;
    static constexpr int NR = FWD ? BP::NR_FWD : BP::NR_REV;
    static constexpr int NSH = FWD ? BP::N_SH : 0;     // lanes carried
    // a non-boundary model's reverse pass: a seed id per state
    static constexpr bool SID = !FWD && BP::TRACK_SID != 0;
    static constexpr int NX = SID ? 1 : NSH;           // rows past sc, pm
    static constexpr int NRL = NR * (2 + NX);          // ring rows a slot
    static constexpr int NSP = FWD ? BP::N_SPANS : 0;  // span registers
    __host__ __device__ static constexpr int cand(int c, int col) {
        return FWD ? BP::fwd(c, col) : BP::rev(c, col);
    }
    __host__ __device__ static constexpr int ring(int s) {
        return FWD ? BP::fwd_ring(s) : BP::rev_ring(s);
    }
    // halo lanes: the largest query advance of an advancing candidate
    __host__ __device__ static constexpr int halo() {
        int h = 0;
        for (int c = 0; c < N_ADV; ++c)
            if (cand(c, BP_AQ) > h) h = cand(c, BP_AQ);
        return h;
    }
    static constexpr int H = halo();
    static constexpr int TMAX = band_tmax(FWD, BP::S, BP::N_SH, SID);
};

template <bool FWD, bool CROSS, bool SMEM_RING>
__global__ void __launch_bounds__(Pass<FWD>::TMAX)
band_kernel(const Params p, const Halo h) {
    using PS = Pass<FWD>;
    constexpr int S = BP::S, NSH = PS::NSH, LN = NSH > 0 ? NSH : 1;
    constexpr int NR = PS::NR, R = BP::K + 1, H = PS::H, NRL = PS::NRL;
    constexpr int NSP = PS::NSP, NSPA = BP::N_SPANS > 0 ? BP::N_SPANS : 1;
    constexpr int NSR = 4 + BP::N_SH;
    constexpr bool SID = PS::SID;
    constexpr int NX = PS::NX, SD = SID ? S : 1;
    constexpr int HL = FWD ? H : 0;     // own lane i at local i - L0 + HL
    static_assert(H <= 32, "one warp copies the halo");
    extern __shared__ __align__(16) int32_t smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, T = (int)blockDim.x;
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / C;
    const int LB = p.k * T, L0 = rank * LB, WB = LB + H;
    int32_t* s_ring = smem;                                     // [R][NRL][WB]
    int32_t* s_st = s_ring + (SMEM_RING ? R * NRL * WB : 0);    // [NSP][NSR][LB]
    int32_t* s_cu = s_st + (SMEM_RING ? NSP * NSR * LB : 0);    // [2][NSP][NSR][LB+1]
    int32_t* s_red = s_cu + (SMEM_RING ? 2 * NSP * NSR * (LB + 1) : 0);

    const int W = p.Qp + 1, WT = p.Wp + 1;
    const int Dp = p.Qp + p.Wp + 1, NW = (p.Qp + 32) / 32;
    const int qlen = p.dims[b * 2 + 0], wlen = p.dims[b * 2 + 1];
    const int32_t* qv = p.qvecs + (size_t)b * p.nq * W;
    const int32_t* tv = p.tvecs + (size_t)b * p.nt * WT;
    const int32_t* scl = p.scalars + (size_t)b * p.ns;
    int32_t* rsc = p.ring_sc + (size_t)b * R * NR * W;
    int32_t* rpm = p.ring_pm + (size_t)b * R * NR * W;
    int32_t* rln = NX ? p.ring_ln + (size_t)b * R * NR * NX * W : nullptr;
    int32_t* bits = p.bits ? p.bits + (size_t)b * Dp * NW : nullptr;
    int32_t* start = BP::TRACK_SID ? p.start + (size_t)b * p.n_seed
                                   : nullptr;
    int32_t* st_g = FWD ? p.span_st + (size_t)b * NSPA * NSR * W : nullptr;
    int32_t* cu_g = FWD ? p.span_cu + (size_t)b * 2 * NSPA * NSR * W
                        : nullptr;
    int32_t* colbest = FWD ? p.colbest + (size_t)b * WT : nullptr;

    // a W-axis vector at column c (0 outside [0, Wp]) and a q-axis vector
    // at lane l (0 outside [0, Qp])
    auto tcol = [&](int row, int c) -> int32_t {
        if constexpr (CROSS) {
            if (c < 0)
                return c >= -h.maxat
                    ? h.tctx[((size_t)b * p.nt + row) * h.maxat - c - 1] : 0;
        }
        return (c >= 0 && c <= p.Wp) ? __ldg(tv + (size_t)row * WT + c) : 0;
    };
    auto qlane = [&](int row, int l) -> int32_t {
        return (l >= 0 && l <= p.Qp) ? __ldg(qv + (size_t)row * W + l) : 0;
    };
    // ring row x of slot sl at lane i: sc rows [0, NR), pm rows [NR, 2NR),
    // lane rows 2NR + rr * NSH + l (forward) or seed-id rows 2NR + rr
    // (non-boundary reverse)
    auto ring_rd = [&](int sl, int x, int i) -> int32_t {
        if constexpr (SMEM_RING) {
            return s_ring[(sl * NRL + x) * WB + i - L0 + HL];
        } else {
            const int32_t* g = x < NR ? rsc + ((size_t)sl * NR + x) * W
                : x < 2 * NR ? rpm + ((size_t)sl * NR + x - NR) * W
                : rln + ((size_t)sl * NR * NX + x - 2 * NR) * W;
            return __ldcg(g + i);
        }
    };
    auto ring_wr = [&](int sl, int x, int i, int32_t v) {
        if constexpr (SMEM_RING) {
            s_ring[(sl * NRL + x) * WB + i - L0 + HL] = v;
        } else {
            int32_t* g = x < NR ? rsc + ((size_t)sl * NR + x) * W
                : x < 2 * NR ? rpm + ((size_t)sl * NR + x - NR) * W
                : rln + ((size_t)sl * NR * NX + x - 2 * NR) * W;
            g[i] = v;
        }
    };
    // span spx's stored register f at own lane i, and its curr register
    // f of parity par at lane i (i = L0 - 1: the halo lane)
    auto st_at = [&](int spx, int f, int i) -> int32_t& {
        if constexpr (SMEM_RING)
            return s_st[(spx * NSR + f) * LB + i - L0];
        else
            return st_g[((size_t)spx * NSR + f) * W + i];
    };
    auto cu_rd = [&](int par, int spx, int f, int i) -> int32_t {
        if constexpr (SMEM_RING)
            return s_cu[((par * NSP + spx) * NSR + f) * (LB + 1) + 1 + i
                        - L0];
        else
            return __ldcg(cu_g + (((size_t)par * NSPA + spx) * NSR + f) * W
                          + i);
    };
    auto cu_wr = [&](int par, int spx, int f, int i, int32_t v) {
        if constexpr (SMEM_RING)
            s_cu[((par * NSP + spx) * NSR + f) * (LB + 1) + 1 + i - L0] = v;
        else
            cu_g[(((size_t)par * NSPA + spx) * NSR + f) * W + i] = v;
    };

    // the span registers' start values (the wrapper's, a CROSS chunk's
    // from its left neighbour), into shared memory
    if constexpr (SMEM_RING && NSP > 0) {
        for (int m = 0; m < p.k; ++m) {
            const int i = L0 + tid + m * T;
            if (i >= W) break;
            for (int spx = 0; spx < NSP; ++spx)
                for (int f = 0; f < NSR; ++f) {
                    st_at(spx, f, i) = st_g[((size_t)spx * NSR + f) * W + i];
                    for (int par = 0; par < 2; ++par)
                        cu_wr(par, spx, f, i,
                              cu_g[(((size_t)par * NSPA + spx) * NSR + f)
                                   * W + i]);
                }
        }
    }
    // the neighbour whose edge lanes this CTA reads (DSMEM), and the warp
    // that copies them: the one whose lanes read the halo
    const int32_t* nb = nullptr;
    if constexpr (SMEM_RING) {
        const int q = FWD ? rank - 1 : rank + 1;
        if (q >= 0 && q < C) nb = cluster.map_shared_rank(smem, q);
    }
    const bool copier = FWD ? tid < 32 : tid >= T - 32;
    // every CTA has started (its shared memory may be read) and holds its
    // span registers
    cluster.sync();

    // the spans' target windows (--maxintron): run-time data, so that one
    // compiled plan serves every window; the plan says which span has one
    int32_t span_max_t[NSPA];
    each<0, NSP>([&](auto spx) {
        span_max_t[spx] = p.spans[spx * SP_COLS + SP_MAX_T];
    });

    bool any_live = false, any_xband = false;
    // non-boundary reverse: the running start score of the last seed id
    // this thread's cells raised (flushed by atomicMax on a change of id
    // and at the end)
    int acc_sid = -1;
    int32_t acc_max = NEG;
    auto flush_start = [&]() {
        if constexpr (SID) {
            if (acc_sid >= 0) atomicMax(start + acc_sid, acc_max);
        }
    };
    const int n_diag = qlen + wlen + 1;
    for (int step = 0; step < n_diag; ++step) {
        const int d = FWD ? step : n_diag - 1 - step;
        const int lo = d - wlen > 0 ? d - wlen : 0;
        const int hi = d < qlen ? d : qlen;
        const int slot = d % R;
        if constexpr (SMEM_RING) {
            if (nb != nullptr && copier) {
                // the neighbour's H edge lanes of the diagonal before
                // (d - 1 forward, d + 1 reverse), every ring row
                const int lane = tid & 31;
                const int ps = FWD ? (slot == 0 ? R - 1 : slot - 1)
                                   : (slot == R - 1 ? 0 : slot + 1);
                for (int x = lane; x < H * NRL; x += 32) {
                    const int at = (ps * NRL + x / H) * WB + x % H;
                    if (FWD)
                        s_ring[at] = nb[at + LB];
                    else
                        s_ring[at + LB] = nb[at];
                }
                if constexpr (FWD && NSP > 0) {
                    // the curr registers of its last lane, parity of d - 1
                    const int32_t* nb_cu = nb + (s_cu - smem);
                    const int par = (d + 1) & 1;
                    for (int x = lane; x < NSP * NSR; x += 32) {
                        const int at = (par * NSP * NSR + x) * (LB + 1);
                        s_cu[at] = nb_cu[at + LB];
                    }
                }
            }
            __syncwarp();
        }
        for (int m = 0; m < p.k; ++m) {
            const int i = L0 + tid + m * T;
            bool flag = false;
            if (i >= lo && i <= hi) {
                const int j = d - i;
                int32_t csc[S], cpm[S], cln[S][LN], csd[SD];
                each<0, S>([&](auto s) {
                    csc[s] = NEG;
                    cpm[s] = NEG;
                    each<0, LN>([&](auto l) { cln[s][l] = 0; });
                });
                each<0, SD>([&](auto s) { csd[s] = 0; });
                bool thaw = false;
                if constexpr (FWD && BP::TRACK_SID) {
                    // each seed's start score less its half score at its
                    // cell, where set; the largest where seeds share it
                    int32_t r = NEG;
                    for (int lx = 0; lx < p.n_layers; ++lx)
                        if (tcol(p.row_seedq + lx, j) - 1 == i) {
                            const int k = tcol(p.row_seedi + lx, j);
                            const int32_t got = (k >= 0 && k < p.n_seed)
                                ? __ldg(start + k) : NEG;
                            if (got > NEG) {
                                const int32_t v =
                                    wsub(got, tcol(p.row_seedh + lx, j));
                                r = v > r ? v : r;
                            }
                        }
                    csc[BP::START_ID] = r;
                    cpm[BP::START_ID] = r;
                } else if constexpr (FWD) {
                    const uint32_t w =
                        (uint32_t)__ldg(bits + (size_t)d * NW + (i >> 5));
                    thaw = (w >> (i & 31)) & 1u;
                    if (thaw) {
                        csc[BP::START_ID] = 0;
                        cpm[BP::START_ID] = 0;
                    }
                } else {
                    int32_t r = NEG, rsd = 0;
                    for (int lx = 0; lx < p.n_layers; ++lx)
                        if (tcol(p.row_seedq + lx, j) - 1 == i) {
                            const int32_t v = tcol(p.row_seedv + lx, j);
                            r = v > r ? v : r;
                            if constexpr (SID) {
                                // the largest seed index at the cell
                                const int32_t k = tcol(p.row_seedi + lx, j);
                                rsd = k > rsd ? k : rsd;
                            }
                        }
                    csc[BP::END_ID] = r;
                    cpm[BP::END_ID] = r;
                    if constexpr (SID) csd[BP::END_ID] = rsd;
                }
                int32_t ev = NEG, ev_sd = 0;

                auto candidate = [&](auto cc) {
                    constexpr int c = decltype(cc)::value;
                    constexpr int aq = PS::cand(c, BP_AQ);
                    constexpr int at = PS::cand(c, BP_AT);
                    constexpr int adv = aq + at;
                    constexpr int r = PS::cand(c, BP_READ);
                    constexpr int w = PS::cand(c, BP_WRITE);
                    constexpr int kind = PS::cand(c, BP_CALC);
                    constexpr int flags = PS::cand(c, BP_FLAGS);
                    constexpr int c0 = PS::cand(c, BP_C0);
                    constexpr int c1 = PS::cand(c, BP_C1);
                    constexpr int c2 = PS::cand(c, BP_C2);
                    constexpr int c3 = PS::cand(c, BP_C3);
                    const int si = FWD ? i - aq : i + aq;
                    const int sj = FWD ? j - at : j + at;
                    if constexpr (CROSS) {
                        // sources up to maxat columns into the neighbour
                        if (si < 0 || si > qlen || sj < (FWD ? -h.maxat : 0)
                            || sj > (FWD ? wlen : wlen + h.maxat))
                            return;
                    } else {
                        if (si < 0 || si > qlen || sj < 0 || sj > wlen)
                            return;
                    }
                    if constexpr (at != 0) {
                        if (tcol(PS::cand(c, BP_CONTIG), FWD ? j : j + at)
                            == 0)
                            return;
                    }
                    int32_t s_sc, s_pm, s_sd = 0;
                    int32_t s_ln[LN];
                    if constexpr (adv == 0) {
                        s_sc = csc[r];
                        s_pm = cpm[r];
                        if constexpr (SID) s_sd = csd[r];
                        each<0, NSH>([&](auto l) { s_ln[l] = cln[r][l]; });
                    } else {
                        constexpr int rr = PS::ring(r);
                        static_assert(rr >= 0, "a ring source has a row");
                        bool halo = false;
                        if constexpr (CROSS) halo = FWD ? sj < 0 : sj > wlen;
                        if (halo) {
                            // the neighbour's edge plane k - 1
                            const int k = FWD ? -sj : sj - wlen;
                            const size_t ex =
                                ((size_t)rr * h.maxat + k - 1) * W + si;
                            s_sc = h.sc_in[ex];
                            s_pm = h.pm_in[ex];
                            each<0, NSH>([&](auto l) {
                                s_ln[l] = h.ln_in[(((size_t)rr * NSH + l)
                                                   * h.maxat + k - 1) * W
                                                  + si];
                            });
                        } else {
                            const int sl = FWD
                                ? (slot >= adv ? slot - adv : slot - adv + R)
                                : (slot + adv < R ? slot + adv
                                                  : slot + adv - R);
                            s_sc = ring_rd(sl, rr, si);
                            s_pm = ring_rd(sl, NR + rr, si);
                            if constexpr (SID)
                                s_sd = ring_rd(sl, 2 * NR + rr, si);
                            each<0, NSH>([&](auto l) {
                                s_ln[l] = ring_rd(sl, 2 * NR + rr * NSH + l,
                                                  si);
                            });
                        }
                    }
                    if (s_sc <= NEG) return;
                    const int qi = FWD ? i - aq : i;
                    const int tj = FWD ? j - at : j;
                    int32_t tsc = 0;
                    if constexpr (kind == K_QT) {
                        tsc = wadd(qlane(c0, qi), tcol(c1, tj));
                    } else if constexpr (kind == K_FACTORED) {
                        const int cls = tcol(c1, tj);
                        tsc = (cls >= 0 && cls < c3) ? qlane(c0 + cls, qi)
                                                     : 0;
                        if constexpr (c2 >= 0) {
                            const int32_t ov = qlane(c2, qi);
                            if (ov != 0) tsc = ov;
                        }
                    } else if constexpr (kind == K_SCALAR) {
                        tsc = scl[c0];
                    } else if constexpr (kind == K_QVEC) {
                        tsc = qlane(c0, qi);
                    } else if constexpr (kind == K_TVEC) {
                        tsc = tcol(c1, tj);
                    } else if constexpr (kind == K_SPLIT && FWD) {
                        // kernel K9 (model/phase.py:305-327): the aa of a
                        // codon split by an intron, decoded from the
                        // packed lanes, indexes the 25 query rows R0..R24
                        // (pre-shifted by aq: read at lane i)
                        if (!(s_ln[c3] >= c2)) {
                            tsc = NEG;
                        } else {
                            int32_t sel, sub = 0;
                            if constexpr (c2 == 1) {
                                sel = s_ln[PS::cand(c, BP_C4)];
                                const int k = floordiv6(sel);
                                if (k >= 0 && k < 3) sub = tcol(c1 + k, tj);
                            } else {
                                sel = tcol(c1, tj);
                                const int k = floordiv6(sel);
                                if (k == 0)
                                    sub = s_ln[PS::cand(c, BP_C4)];
                                else if (k == 1)
                                    sub = s_ln[PS::cand(c, BP_C5)];
                                else if (k == 2)
                                    sub = s_ln[PS::cand(c, BP_C6)];
                            }
                            int field = sel % 6;
                            if (field < 0) field += 6;
                            const int aa = (sub >> (5 * field)) & 31;
                            tsc = aa < 25 ? qlane(c0 + aa, i) : 0;
                        }
                    }
                    if constexpr (FWD && (flags & (BF_SH_Q | BF_SH_T)) != 0) {
                        // intron length window (model/intron.py:140-149)
                        const int32_t mn = scl[PS::cand(c, BP_SH_MIN)];
                        const int32_t mx = scl[PS::cand(c, BP_SH_MAX)];
                        bool bad = false;
                        if constexpr ((flags & BF_SH_Q) != 0) {
                            const int32_t len = wadd(
                                wsub(i - aq, s_ln[PS::cand(c, BP_SH_LANE_Q)]),
                                2);
                            bad = bad || len < mn || len > mx;
                        }
                        if constexpr ((flags & BF_SH_T) != 0) {
                            const int32_t len = wadd(
                                wsub(tcol(BP::ROW_ABS_T, j - at),
                                     s_ln[PS::cand(c, BP_SH_LANE_T)]), 2);
                            bad = bad || len < mn || len > mx;
                        }
                        if (bad) tsc = NEG;
                    }
                    int32_t val = kind != K_NONE ? wadd(s_sc, tsc) : s_sc;
                    if constexpr ((flags & BF_P_UNDER) != 0) {
                        if (val < NEG) val = NEG;
                    }
                    if constexpr ((flags & BF_P_OVER) != 0) {
                        if (val > POS) val = POS;
                    }
                    if (FWD && val < 0) return;
                    if (wsub(s_pm, val) > p.dropoff) return;
                    if (!(val > csc[w])) return;        // first max wins
                    csc[w] = val;
                    cpm[w] = s_pm > val ? s_pm : val;
                    if constexpr (SID) csd[w] = s_sd;
                    if constexpr (NSH > 0) {
                        constexpr int n0 = PS::cand(c, BP_NSTART);
                        each<0, (n0 < MAX_STARTS ? n0 : MAX_STARTS)>(
                            [&](auto kc) {
                                constexpr int k = decltype(kc)::value;
                                constexpr int des =
                                    PS::cand(c, BP_ST_DES0 + 2 * k);
                                constexpr int src =
                                    PS::cand(c, BP_ST_SRC0 + 2 * k);
                                if constexpr (src == ST_TARGET)
                                    s_ln[des] = tcol(BP::ROW_ABS_T, j - at);
                                else if constexpr (src == ST_QUERY)
                                    s_ln[des] = i - aq;
                                else
                                    s_ln[des] = tcol(src - ST_TVEC, j - at);
                            });
                        each<0, NSH>([&](auto l) { cln[w][l] = s_ln[l]; });
                    }
                    if constexpr (FWD && (flags & BF_EVENT) != 0) {
                        if (val >= s_pm) ev = val;
                    }
                    if constexpr (SID && (flags & BF_EVENT) != 0) {
                        // a START event: overwritten in candidate order
                        if (val >= s_pm) {
                            ev = val;
                            ev_sd = s_sd;
                        }
                    }
                };

                each<0, PS::N_ADV>(candidate);

                if constexpr (NSP > 0) {
                    // span thaw + submit, before the silent sweep
                    const int32_t abs_tv = tcol(BP::ROW_ABS_T, j);
                    const int32_t seg = tcol(BP::ROW_SEG, j);
                    const int pc = d & 1, pp = pc ^ 1;   // curr, prev parity
                    each<0, NSP>([&](auto spc) {
                        constexpr int spx = decltype(spc)::value;
                        constexpr int st = BP::spans(spx, SP_STATE);
                        const int32_t max_t = span_max_t[spx];
                        constexpr bool joint = BP::spans(spx, SP_MAX_Q) > 0;
                        constexpr bool post = BP::spans(spx, SP_POST_THAW);
                        // a query-only span (no target window): no-op
                        if constexpr (BP::spans(spx, SP_MAX_T) != 0) {
                            int32_t st_sc = st_at(spx, 0, i);
                            int32_t st_pm = st_at(spx, 1, i);
                            int32_t st_te = st_at(spx, 2, i);
                            int32_t st_sg = st_at(spx, 3, i);
                            int32_t st_ln[LN], cu_ln[LN];
                            each<0, NSH>([&](auto l) {
                                st_ln[l] = st_at(spx, 4 + l, i);
                                cu_ln[l] = 0;
                            });
                            // joint: lane i - 1 of the previous diagonal
                            // (fill at lane 0); target-only: own lane
                            const int src = joint ? i - 1 : i;
                            int32_t cu_sc = NEG, cu_pm = 0, cu_te = 0;
                            int32_t cu_sg = 0;
                            if (src >= 0) {
                                cu_sc = cu_rd(pp, spx, 0, src);
                                cu_pm = cu_rd(pp, spx, 1, src);
                                cu_te = cu_rd(pp, spx, 2, src);
                                cu_sg = cu_rd(pp, spx, 3, src);
                                each<0, NSH>([&](auto l) {
                                    cu_ln[l] = cu_rd(pp, spx, 4 + l, src);
                                });
                            }
                            bool upd;
                            if constexpr (joint) {
                                const bool r_ok = cu_sc > NEG
                                    && wadd(cu_te, max_t) >= abs_tv;
                                const bool st_ok = st_sc > NEG
                                    && wadd(st_te, max_t) >= abs_tv;
                                upd = thaw && st_ok
                                    && (!r_ok || cu_sc < st_sc);
                                cu_sc = upd ? st_sc : (r_ok ? cu_sc : NEG);
                            } else {
                                const bool in_w =
                                    wadd(st_te, max_t) >= abs_tv;
                                if (thaw && st_sc > NEG && !in_w) st_sc = NEG;
                                const bool cu_ok = cu_sc > NEG
                                    && wadd(cu_te, max_t) >= abs_tv;
                                upd = thaw && st_sc > NEG && in_w
                                    && (!cu_ok || cu_sc < st_sc);
                                if (upd)
                                    cu_sc = st_sc;
                                else if (thaw && !cu_ok)
                                    cu_sc = NEG;
                            }
                            if (upd) {
                                cu_pm = st_pm;
                                cu_te = st_te;
                                cu_sg = st_sg;
                                each<0, NSH>([&](auto l) {
                                    cu_ln[l] = st_ln[l];
                                });
                            }
                            const bool th = thaw && cu_sc > NEG
                                && csc[st] < cu_sc;
                            if (th && cu_sg != seg) any_xband = true;
                            int32_t sub_sc = csc[st], sub_pm = cpm[st];
                            int32_t sub_ln[LN];
                            each<0, NSH>([&](auto l) {
                                sub_ln[l] = cln[st][l];
                            });
                            if (th) {
                                csc[st] = cu_sc;
                                cpm[st] = cu_pm;
                                each<0, NSH>([&](auto l) {
                                    cln[st][l] = cu_ln[l];
                                });
                                if constexpr (post) {
                                    sub_sc = cu_sc;
                                    sub_pm = cu_pm;
                                    each<0, NSH>([&](auto l) {
                                        sub_ln[l] = cu_ln[l];
                                    });
                                }
                            }
                            if (sub_sc >= 0 && sub_sc >= st_sc) {
                                st_sc = sub_sc;
                                st_pm = sub_pm;
                                st_te = abs_tv;
                                st_sg = seg;
                                each<0, NSH>([&](auto l) {
                                    st_ln[l] = sub_ln[l];
                                });
                            }
                            st_at(spx, 0, i) = st_sc;
                            st_at(spx, 1, i) = st_pm;
                            st_at(spx, 2, i) = st_te;
                            st_at(spx, 3, i) = st_sg;
                            cu_wr(pc, spx, 0, i, cu_sc);
                            cu_wr(pc, spx, 1, i, cu_pm);
                            cu_wr(pc, spx, 2, i, cu_te);
                            cu_wr(pc, spx, 3, i, cu_sg);
                            each<0, NSH>([&](auto l) {
                                st_at(spx, 4 + l, i) = st_ln[l];
                                cu_wr(pc, spx, 4 + l, i, cu_ln[l]);
                            });
                        }
                    });
                }

                each<PS::N_ADV, PS::N>(candidate);

                bool live_cell = false;
                each<0, S>([&](auto s) { live_cell |= csc[s] > NEG; });
                if (live_cell && tcol(BP::ROW_EDGE, j) != 0) any_live = true;
                if constexpr (FWD) {
                    if (ev > NEG && ev > __ldcg(colbest + j)) colbest[j] = ev;
                } else if constexpr (SID) {
                    if (ev > NEG && ev_sd >= 0 && ev_sd < p.n_seed) {
                        if (ev_sd != acc_sid) {
                            flush_start();
                            acc_sid = ev_sd;
                            acc_max = ev;
                        } else if (ev > acc_max) {
                            acc_max = ev;
                        }
                    }
                } else {
                    flag = csc[BP::START_ID] >= 0;
                    each<0, BP::N_SPANS>([&](auto spc) {
                        flag |= csc[BP::spans(decltype(spc)::value,
                                              SP_STATE)] > 0;
                    });
                }
                if constexpr (CROSS) {
                    // halo export: edge column k of this chunk
                    const int k = FWD ? wlen + 1 - j : j + 1;
                    if (k >= 1 && k <= h.maxat)
                        each<0, S>([&](auto sc_) {
                            constexpr int s = decltype(sc_)::value;
                            constexpr int rr = PS::ring(s);
                            if constexpr (rr >= 0) {
                                const size_t ex =
                                    ((size_t)rr * h.maxat + k - 1) * W + i;
                                h.sc_out[ex] = csc[s];
                                h.pm_out[ex] = cpm[s];
                                each<0, NSH>([&](auto l) {
                                    h.ln_out[(((size_t)rr * NSH + l)
                                              * h.maxat + k - 1) * W + i] =
                                        cln[s][l];
                                });
                            }
                        });
                }
                // the ring store: this lane's entry of slot d % R
                each<0, S>([&](auto sc_) {
                    constexpr int s = decltype(sc_)::value;
                    constexpr int rr = PS::ring(s);
                    if constexpr (rr >= 0) {
                        ring_wr(slot, rr, i, csc[s]);
                        ring_wr(slot, NR + rr, i, cpm[s]);
                        if constexpr (SID)
                            ring_wr(slot, 2 * NR + rr, i, csd[s]);
                        each<0, NSH>([&](auto l) {
                            ring_wr(slot, 2 * NR + rr * NSH + l, i,
                                    cln[s][l]);
                        });
                    }
                });
            }
            if constexpr (!FWD && !SID) {
                // 32 lanes per word, a warp's lanes 32-aligned in one CTA
                const unsigned word = __ballot_sync(0xffffffffu, flag);
                const int i0 = i - (tid & 31);
                if ((tid & 31) == 0 && (i0 >> 5) < NW && i0 <= hi
                    && i0 + 31 >= lo)
                    bits[(size_t)d * NW + (i0 >> 5)] = (int32_t)word;
            }
        }
        cluster.sync();
    }
    flush_start();
    // a CROSS chunk's span registers, back for the wrapper
    if constexpr (SMEM_RING && CROSS && NSP > 0) {
        for (int m = 0; m < p.k; ++m) {
            const int i = L0 + tid + m * T;
            if (i >= W) break;
            for (int spx = 0; spx < NSP; ++spx)
                for (int f = 0; f < NSR; ++f) {
                    st_g[((size_t)spx * NSR + f) * W + i] = st_at(spx, f, i);
                    for (int par = 0; par < 2; ++par)
                        cu_g[(((size_t)par * NSPA + spx) * NSR + f) * W + i] =
                            cu_rd(par, spx, f, i);
                }
        }
    }
    // live and xband: each CTA's block OR, then rank 0's OR of the
    // cluster's through distributed shared memory
    const int live = __syncthreads_or(any_live);
    const int xb = FWD ? __syncthreads_or(any_xband) : 0;
    if (tid == 0) {
        s_red[0] = live;
        s_red[1] = xb;
    }
    cluster.sync();
    if (rank == 0 && tid == 0) {
        int lv = 0, xv = 0;
        for (int q = 0; q < C; ++q) {
            const int32_t* o = cluster.map_shared_rank(s_red, q);
            lv |= o[0];
            xv |= o[1];
        }
        p.live[b] = lv ? 1 : 0;
        if (FWD) p.xband[b] = xv ? 1 : 0;
    }
    // rank 0 has read every CTA's shared memory before any CTA exits
    cluster.sync();
}

// A pass's launch: its fit at the largest cluster the card admits
// (MAX_CLUSTER, else PORTABLE_CLUSTER), the ring route it gives, then the
// launch.  fit_out: C, T, whether the ring is in shared memory.  A size
// that cannot launch is an error: there is no fallback.
template <bool FWD, bool CROSS>
cudaError_t launch(Params p, const Halo& h, int rows, int* fit_out,
                   cudaStream_t stream) {
    using PS = Pass<FWD>;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    for (const int cmax : {MAX_CLUSTER, PORTABLE_CLUSTER}) {
        const BandFit f = band_fit(FWD, rows, p.B, sms, cmax, PS::TMAX,
                                   BP::K + 1, PS::NR, PS::NSH, PS::NSP,
                                   PS::H, PS::SID);
        auto kern = f.smem_ring ? band_kernel<FWD, CROSS, true>
                                : band_kernel<FWD, CROSS, false>;
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
        if (cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)f.smem) != cudaSuccess) {
            (void)cudaGetLastError();
            continue;
        }
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = f.C;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(p.B * f.C, 1, 1);
        cfg.blockDim = dim3(f.T, 1, 1);
        cfg.dynamicSmemBytes = f.smem;
        cfg.stream = stream;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int n = 0;
        if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess
            || n < 1) {
            (void)cudaGetLastError();     // a refused size: not sticky
            continue;
        }
        p.k = f.k;
        fit_out[0] = f.C;
        fit_out[1] = f.T;
        fit_out[2] = f.smem_ring;
        err = cudaLaunchKernelEx(&cfg, kern, p, h);
        if (err != cudaSuccess) return err;
        return cudaGetLastError();
    }
    return cudaErrorInvalidConfiguration;
}

#endif  // COMPILED_PLAN

}  // namespace

#ifdef COMPILED_PLAN
#define SDP_BAND_BASE_ARGS                                                   \
    const int32_t *spans, const int32_t *dims, const int32_t *qvecs,        \
        const int32_t *tvecs,                                               \
        const int32_t *scalars, int32_t *bits, int32_t *ring_sc,            \
        int32_t *ring_pm, int32_t *ring_ln, int32_t *span_st,               \
        int32_t *span_cu, int32_t *colbest, int32_t *live, int32_t *xband,  \
        int32_t *start, int nq, int nt, int ns, int B, int Qp, int Wp,      \
        int dropoff, int row_seedq, int row_seedv, int n_layers,            \
        int row_seedi, int row_seedh, int n_seed, int rows, int *fit_out

// a non-boundary plan (TRACK_SID) takes start and its seed-id rows in
// place of the boundary bits
#define SDP_BAND_PARAMS                                                      \
    if (B <= 0) return 0;                                                    \
    if (n_layers > MAX_SEED_LAYERS) return (int)cudaErrorInvalidValue;      \
    if (BP::TRACK_SID ? (start == nullptr || n_seed < 1 || row_seedi < 0   \
                         || row_seedh < 0)                                  \
                      : bits == nullptr)                                    \
        return (int)cudaErrorInvalidValue;                                  \
    Params p{spans,     dims,      qvecs,     tvecs,    scalars, bits,      \
             ring_sc,   ring_pm,   ring_ln,   span_st,  span_cu, colbest,   \
             live,      xband,     start,     nq,       nt,      ns,        \
             B,         Qp,        Wp,        dropoff,  row_seedq,          \
             row_seedv, n_layers,  row_seedi, row_seedh, n_seed, 1}

#define SDP_HALO_ARGS                                                        \
    const int32_t *tctx, const int32_t *sc_in, const int32_t *pm_in,        \
        const int32_t *ln_in, int32_t *sc_out, int32_t *pm_out,             \
        int32_t *ln_out, int maxat

// The launches: the span table of the run (its windows), the
// per-comparison arguments (the rest of the plan is BandPlan's), rows
// the batch's widest comparison's lanes (its largest qlen + 1), fit_out
// the cluster launched (C, T, ring in shared memory).

// K6: the reverse pass.  Writes bits and live (a non-boundary plan:
// raises start, which comes NEG-filled, and writes live).
extern "C" int sdp_band_reverse(SDP_BAND_BASE_ARGS, void *stream) {
    SDP_BAND_PARAMS;
    return (int)launch<false, false>(p, Halo{}, rows, fit_out,
                                     (cudaStream_t)stream);
}

// K7: the forward pass from K6's bits (a non-boundary plan: from its
// start scores).  Writes colbest, live and xband; span_st / span_cu come
// initialised (sc rows NEG, the rest 0).
extern "C" int sdp_band_forward(SDP_BAND_BASE_ARGS, void *stream) {
    SDP_BAND_PARAMS;
    return (int)launch<true, false>(p, Halo{}, rows, fit_out,
                                    (cudaStream_t)stream);
}

// K8, reverse: K6 on one chunk of one comparison, reading the right
// neighbour's edge planes and writing its own first columns'.
extern "C" int sdp_band_reverse_cross(SDP_BAND_BASE_ARGS, SDP_HALO_ARGS,
                                      void *stream) {
    SDP_BAND_PARAMS;
    if (B != 1 || maxat < 1 || BP::TRACK_SID) return (int)cudaErrorInvalidValue;
    const Halo h{tctx, sc_in, pm_in, ln_in, sc_out, pm_out, ln_out, maxat};
    return (int)launch<false, true>(p, h, rows, fit_out,
                                    (cudaStream_t)stream);
}

// K8, forward: K7 on one chunk, reading the left neighbour's edge planes
// (span registers seeded by the wrapper) and writing its last columns'.
extern "C" int sdp_band_forward_cross(SDP_BAND_BASE_ARGS, SDP_HALO_ARGS,
                                      void *stream) {
    SDP_BAND_PARAMS;
    if (B != 1 || maxat < 1 || BP::TRACK_SID) return (int)cudaErrorInvalidValue;
    const Halo h{tctx, sc_in, pm_in, ln_in, sc_out, pm_out, ln_out, maxat};
    return (int)launch<true, true>(p, h, rows, fit_out,
                                   (cudaStream_t)stream);
}
#endif  // COMPILED_PLAN
