// Traceback walk-back over K4's plan-id planes, hand-written for Hopper.
//
// Replaces exonerate_tpu/engine/pallas_wavefront.py:_build_walkback
// (:1550; the per-pair jax.lax.while_loop :1564-1587, vmapped over the
// batch), and the host walk of the checkpointed traceback
// (exonerate_tpu/engine/wavefront.py:762-801).  A walk starts at a cell
// (i, j) in a state and follows the winning plan ids back: each id names
// a transition whose advances step (i, j) back and whose input is the
// next state.  It stops on id 0 or after `cap` steps, and ends after a
// transition from START (ref: viterbi.c:342-392).
//
// Two entry points over one body:
// - walkback_launch: each pair from its best end cell (stats rows 1-2) in
//   the END state over its whole (D, S, W) cube, d and i clamped into
//   the cube as _build_walkback clips them (:1570-1572); out the op list
//   (end->start), its length and the start cell;
// - walk_segment_launch: each pair from a given cell and state over the
//   planes of diagonals [d0, d0 + D) (a segment of the checkpointed
//   traceback), stopping also when the next cell's diagonal falls below
//   d0; out the ops, the exit cell and state, and why it stopped.
//
// What bounds it on the H100: latency.  A walk is a chain of dependent
// steps, one plan id per step, and there is no parallelism inside a pair.
// Read straight from device memory (the first version: one thread per
// pair) each step waited on a DRAM round trip, ~230 ns.  Here one warp
// runs a walk over tiles of the planes in shared memory:
// - a tile spans the diagonals [d - TD + 1, d] x the query columns
//   [i - TC + 1, i] from the cell that needs it (d and i only fall along a
//   walk), in a fixed slot per state; the warp loads the rows of the
//   states the walk is in with 16-byte cp.async copies (5 per row of TC =
//   64 columns: a row of the planes starts at any byte, so a tile row
//   keeps its first byte's offset in its 16, and the walk adds it back),
//   and the warp walks in shared memory, every lane the same steps (lane
//   0 writes the ops), until the next cell leaves the tile or enters a
//   state not loaded;
// - a state the walk enters is loaded then (a stall): a walk stays in
//   one or two states for long stretches (a match run, an intron), so a
//   tile moves ~TD x TC bytes a state, not all S;
// - meanwhile the next tile is in flight into the second buffer, placed
//   where the walk's course through the last tile (columns per diagonal,
//   entry to exit) leaves this one: by its bottom edge (straight down for
//   an intron, d - 1 at a fixed i) or by its left edge (a match run, one
//   column every two diagonals), MARGIN diagonals and columns past it; a
//   walk that lands elsewhere loads anew;
// - the states loaded are those the walk visited in the tile before,
//   and its own;
// - the id table is packed into one word per id in shared memory (the
//   diagonal and column advances, the next state, a START flag, a stop
//   flag for id 0 and the ids past the table), so a step is two
//   dependent shared-memory loads (the id, its entry) and a few integer
//   ops on the cell's place in the tile (its row from a row change kept
//   in the id's entry), the next id's load issued, predicated, before
//   the branch that ends the steps.
// Tile shape: TC = 64 columns; TD = TC x r diagonals, r the most
// diagonals a step spends per query column (ceil((aq + at) / aq) over the
// ids with aq > 0: 2 for a match, 4 for a codon step), so that a walk of
// such steps crosses the tile's columns and its diagonals together; TD is
// capped so a buffer holds TD x S rows in TILE_BYTES (TD = 128 for
// est2genome's 10 states; the Python mirror is wavefront.walk_tile).
// The chain floor is the steps times one shared-memory load-to-use
// latency (smem_chase_launch measures it); the bytes bound means little
// for a dependent chain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_IDS = 256;      // plan ids are uint8
constexpr int MAX_STATES = 32;    // the loaded states are a 32-bit mask
constexpr int TC = 64;            // tile columns
constexpr int BLOCKS = TC / 16 + 1;                 // 16-byte copies a row
constexpr int ROW_BYTES = 16 * BLOCKS;
constexpr int TILE_BYTES = 112 * 1024;              // one buffer
constexpr int TILE_ROWS = TILE_BYTES / ROW_BYTES;   // (diagonal, state) rows
constexpr int MARGIN = 4;         // a tile in flight reaches past the course
// an id's entry in the packed table: aq (bits 0-3), aq + at (4-7), the
// next state (8-12), FROM_START, STOP (id 0, or not a plan id), and in
// bits 16-31 the change of the cell's tile row, next state - (aq + at) x S
constexpr uint32_t FROM_START = 1u << 13;
constexpr uint32_t STOP = 1u << 14;

// why a walk stopped (wavefront.WALK_*)
enum Status { END = 0, START = 1, CAP = 2, LEFT = 3, BAD = 4 };

struct Tile {
    int dlo, dhi, c0, c1;         // diagonals (planes' own index), columns
    uint32_t states;              // the states whose rows are loaded
};

__device__ __forceinline__ bool inside(const Tile& t, int dc, int ic) {
    return dc >= t.dlo && dc <= t.dhi && ic >= t.c0 && ic <= t.c1;
}

// Issue the copies of the rows of `states` of tile t of `planes` (S
// states, W columns) into buf, row (d - dlo) x S + s: each lane copies
// every 32nd 16-byte block that holds a byte of the columns [c0, c1].
__device__ __forceinline__ void load_rows(uint8_t* buf,
                                          const uint8_t* planes,
                                          const Tile& t, uint32_t states,
                                          int S, int W, int lane) {
    const int nd = t.dhi - t.dlo + 1, nc = t.c1 - t.c0 + 1;
    const uint32_t dst0 = (uint32_t)__cvta_generic_to_shared(buf);
    const size_t stride = (size_t)S * W;      // a state's rows, d to d + 1
    for (uint32_t m = states; m; m &= m - 1) {
        const int s = __ffs(m) - 1;
        const uint8_t* g0 = planes + ((size_t)t.dlo * S + s) * W + t.c0;
        for (int w = lane; w < nd * BLOCKS; w += 32) {
            const int x = w / BLOCKS, k = w - x * BLOCKS;
            const uintptr_t g = (uintptr_t)(g0 + x * stride);
            const uintptr_t ga = (g & ~(uintptr_t)15) + 16 * k;
            if (ga < g + nc) {
                asm volatile(
                    "cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                        dst0 + (x * S + s) * ROW_BYTES + 16 * k),
                    "l"(ga)
                    : "memory");
            }
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The byte at shared address addr where p, else 0: a predicated load, so
// that the next step's id is in flight before the branch that ends the
// steps (a plain load under an if is compiled behind that branch).
__device__ __forceinline__ int load_u8_if(bool p, uint32_t addr) {
    uint32_t v;
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\tmov.b32 %0, 0;\n\t"
        "@q ld.shared.u8 %0, [%1];\n\t}"
        : "=r"(v)
        : "r"(addr), "r"((int)p)
        : "memory");
    return (int)v;
}

__device__ __forceinline__ void wait_tiles() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
}

// The walk of one pair over `planes` (D diagonals from d0, S, W) with
// the warp's two tile buffers at tiles[0] and tiles[TILE_BYTES]; every
// lane runs it (the same steps, so no lane waits on another), lane 0
// writes the ops.  SEGMENT: stop when the cell's diagonal falls below
// d0, else clamp it to d0 as _build_walkback does.
template <bool SEGMENT>
__device__ __forceinline__ void walk_pair(
        const uint8_t* planes, int D, int d0, int S, int W,
        const uint32_t* tab, int TD, int cap, uint8_t* tiles, int& i,
        int& j, int& s, int& k, int& status, int32_t* ops) {
    // (tab and tiles are shared arrays, tiles' two buffers at offsets 0
    // and TILE_BYTES; cur is the walk's)
    const int lane = threadIdx.x;
    const uint32_t W16 = W & 15;
    const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(tiles);
    int cur = 0;                  // the buffer the walk reads
    Tile tc{1, 0, 1, 0, 0u}, tn{1, 0, 1, 0, 0u};     // none yet
    bool pending = false;
    int ent_d = 0, ent_i = 0;     // where the walk entered the tile
    uint32_t seen = 0;            // the states it visited there
    while (true) {
        const int d = i + j;
        if (SEGMENT && d < d0) {
            status = LEFT;
            break;
        }
        const int dc = min(max(d - d0, 0), D - 1);
        const int ic = min(max(i, 0), W - 1);
        if (!inside(tc, dc, ic)) {
            if (tc.states == 0) {
                ent_d = dc;
                ent_i = ic;
            }
            // the walk's course through the tile it leaves, and the
            // states it visited there
            const int run_d = ent_d - dc, run_i = ent_i - ic;
            const uint32_t want = seen | (1u << s);
            if (pending && inside(tn, dc, ic)) {
                cur ^= TILE_BYTES;
                tc = tn;
            } else {
                tc.dhi = dc;
                tc.dlo = max(0, dc - TD + 1);
                tc.c0 = max(0, ic - TC + 1);
                tc.c1 = min(W, tc.c0 + TC) - 1;
                tc.states = want;
                load_rows(tiles + cur, planes, tc, want, S, W, lane);
            }
            wait_tiles();     // this tile, and the other buffer free
            ent_d = dc;
            ent_i = ic;
            seen = 1u << s;
            // the tile in flight: where the course leaves this one, by
            // its bottom edge or by its left edge
            int ex_d = tc.dlo - 1, ex_i = ic;
            if (run_d > 0 && run_i > 0) {
                const int fall = (dc - tc.dlo + 1) * run_i / run_d;
                if (ic - fall >= tc.c0) {
                    ex_i = ic - fall;
                } else {
                    ex_i = tc.c0 - 1;
                    ex_d = dc - ((ic - tc.c0 + 1) * run_d + run_i - 1) / run_i;
                }
            }
            pending = ex_d >= 0 && ex_i >= 0;
            if (pending) {
                tn.dhi = min(ex_d + MARGIN, D - 1);
                tn.dlo = max(0, tn.dhi - TD + 1);
                tn.c1 = min(ex_i + MARGIN, W - 1);
                tn.c0 = max(0, tn.c1 - TC + 1);
                tn.c1 = min(W, tn.c0 + TC) - 1;
                tn.states = want;
                load_rows(tiles + (cur ^ TILE_BYTES), planes, tn, want, S, W,
                          lane);
            }
        }
        if (!((tc.states >> s) & 1)) {
            // a state the tile has not loaded: its rows here, and in the
            // tile in flight
            load_rows(tiles + cur, planes, tc, 1u << s, S, W, lane);
            tc.states |= 1u << s;
            if (pending) {
                load_rows(tiles + (cur ^ TILE_BYTES), planes, tn, 1u << s, S,
                          W, lane);
                tn.states |= 1u << s;
            }
            wait_tiles();
        }
        // the steps inside the tile: (x, y) the cell's place in it, r its
        // row; row r's first byte is at planes + (dlo x S + r) x W + c0,
        // at its offset mod 16 in the tile's row.  x and y only fall, so
        // the walk leaves the tile when one turns negative; i and j follow
        // them at the end
        int x = dc - tc.dlo, y = ic - tc.c0;
        const int x0 = x, y0 = y;
        const uint32_t boff = (uint32_t)(uintptr_t)(planes + tc.c0)
                              + (uint32_t)tc.dlo * (uint32_t)S * (uint32_t)W;
        const uint32_t states = tc.states;
        int32_t* out = ops + k;
        int left = cap - k;       // steps to the cap (a kernel argument
                                  // is reloaded at each use in a loop)
        int r = x * S + s;
        int at = cur + r * ROW_BYTES + y
                 + (int)((boff + (uint32_t)r * W16) & 15);
        int tid = tiles[at];
        uint32_t e;
        bool halt;
        while (true) {
            e = tab[tid];
            // the next cell: its row from the entry's row change, and its
            // id loaded where the walk goes on in the tile, before the
            // branch that ends the steps (bitwise, not &&: a short circuit
            // is compiled as a branch)
            const int nr = r - s + ((int)e >> 16);
            const int ny = y - (int)(e & 15);
            const int nx = x - (int)((e >> 4) & 15);
            const int ns = (e >> 8) & 31;
            const uint32_t m = 1u << ns;
            at = cur + nr * ROW_BYTES + ny
                 + (int)((boff + (uint32_t)nr * W16) & 15);
            halt = ((e & STOP) != 0) | (left <= 0);
            const bool on = ((e & (STOP | FROM_START)) == 0) & (left > 0)
                            & ((nx | ny) >= 0) & ((states & m) != 0);
            const int next = load_u8_if(on, sbase + at);
            if (lane == 0 && !halt) *out = tid;
            if (!halt) {
                ++out;
                --left;
                r = nr;
                s = ns;
                x = nx;
                y = ny;
                seen |= m;
            }
            if (!on) break;
            tid = next;
        }
        k = cap - left;
        i += y - y0;
        j += (x - x0) - (y - y0);
        if (halt) {
            status = tid == 0 ? END : (left <= 0 ? CAP : BAD);
            break;
        }
        if (e & FROM_START) {
            status = START;
            break;
        }
    }
    if (pending) wait_tiles();
}

// The id table packed one word per id (its fields above; id 0 and the
// ids past the table STOP), and the tile's diagonals, TD = min(TC x r,
// TILE_ROWS / S) (wavefront.walk_tile).
__device__ int load_table(const int32_t* walk, int n_ids, int S,
                          uint32_t* tab) {
    for (int t = threadIdx.x; t < MAX_IDS; t += blockDim.x) {
        if (t == 0 || t >= n_ids) {
            tab[t] = STOP;
            continue;
        }
        const int aq = walk[t], adv = aq + walk[n_ids + t];
        const int in = walk[2 * n_ids + t];
        tab[t] = (uint32_t)aq | ((uint32_t)adv << 4) | ((uint32_t)in << 8)
                 | (walk[3 * n_ids + t] ? FROM_START : 0u)
                 | ((uint32_t)(in - adv * S) << 16);
    }
    __syncthreads();
    int r = 1;
    for (int t = 1; t < n_ids; ++t) {
        const int aq = tab[t] & 15, adv = (tab[t] >> 4) & 15;
        if (aq > 0) r = max(r, (adv + aq - 1) / aq);
    }
    return max(1, min(TC * r, TILE_ROWS / S));
}

__global__ void __launch_bounds__(32)
walkback_kernel(const uint8_t* tb, const int32_t* stats, const int32_t* walk,
                int n_ids, int end_id, int B, int D, int S, int W, int cap,
                int32_t* ops, int32_t* res) {
    extern __shared__ __align__(16) uint8_t tiles[];
    __shared__ uint32_t tab[MAX_IDS];
    const int TD = load_table(walk, n_ids, S, tab);
    const int b = blockIdx.x;
    // stats rows: score, query_end, target_end (wavefront output)
    int i = stats[1 * B + b], j = stats[2 * B + b], s = end_id, k = 0;
    int status;
    walk_pair<false>(tb + (size_t)b * D * S * W, D, 0, S, W, tab, TD, cap,
                     tiles, i, j, s, k, status, ops + (size_t)b * cap);
    if (threadIdx.x == 0) {
        res[0 * B + b] = status == BAD ? cap : k;   // an overlong walk
        res[1 * B + b] = i;
        res[2 * B + b] = j;
    }
}

__global__ void __launch_bounds__(32)
walk_segment_kernel(const uint8_t* planes, int d0, const int32_t* cell,
                    const int32_t* walk, int n_ids, int B, int D, int S,
                    int W, int cap, int32_t* ops, int32_t* res) {
    extern __shared__ __align__(16) uint8_t tiles[];
    __shared__ uint32_t tab[MAX_IDS];
    const int TD = load_table(walk, n_ids, S, tab);
    const int b = blockIdx.x;
    int i = cell[0 * B + b], j = cell[1 * B + b], s = cell[2 * B + b];
    int k = 0, status;
    walk_pair<true>(planes + (size_t)b * D * S * W, D, d0, S, W, tab, TD,
                    cap, tiles, i, j, s, k, status, ops + (size_t)b * cap);
    if (threadIdx.x == 0) {
        res[0 * B + b] = k;
        res[1 * B + b] = i;
        res[2 * B + b] = j;
        res[3 * B + b] = s;
        res[4 * B + b] = status;
    }
}

// A chain of n dependent shared-memory loads (a pointer chase): the
// load-to-use latency in clocks, the walk's floor per step.
__global__ void smem_chase_kernel(int n, long long* out) {
    __shared__ int next[1024];
    for (int t = threadIdx.x; t < 1024; t += blockDim.x)
        next[t] = (t * 97 + 1) & 1023;
    __syncthreads();
    if (threadIdx.x != 0) return;
    int p = 0;
    const long long t0 = clock64();
#pragma unroll 16
    for (int t = 0; t < n; ++t) p = next[p];
    const long long t1 = clock64();
    out[0] = t1 - t0;
    out[1] = p;               // keeps the chain
}

template <typename K>
int prepare(K kernel) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * TILE_BYTES);
}

}  // namespace

extern "C" int walkback_launch(const uint8_t* tb, const int32_t* stats,
                               const int32_t* walk, int n_ids, int end_id,
                               int B, int D, int S, int W, int cap,
                               int32_t* ops, int32_t* res, void* stream) {
    if (B <= 0) return 0;
    if (n_ids > MAX_IDS || S <= 0 || S > MAX_STATES || D <= 0 || W <= 0)
        return (int)cudaErrorInvalidValue;
    if (int rc = prepare(walkback_kernel)) return rc;
    walkback_kernel<<<B, 32, 2 * TILE_BYTES, (cudaStream_t)stream>>>(
        tb, stats, walk, n_ids, end_id, B, D, S, W, cap, ops, res);
    return (int)cudaGetLastError();
}

extern "C" int walk_segment_launch(const uint8_t* planes, int d0,
                                   const int32_t* cell, const int32_t* walk,
                                   int n_ids, int B, int D, int S, int W,
                                   int cap, int32_t* ops, int32_t* res,
                                   void* stream) {
    if (B <= 0) return 0;
    if (n_ids > MAX_IDS || S <= 0 || S > MAX_STATES || D <= 0 || W <= 0)
        return (int)cudaErrorInvalidValue;
    if (int rc = prepare(walk_segment_kernel)) return rc;
    walk_segment_kernel<<<B, 32, 2 * TILE_BYTES, (cudaStream_t)stream>>>(
        planes, d0, cell, walk, n_ids, B, D, S, W, cap, ops, res);
    return (int)cudaGetLastError();
}

extern "C" int smem_chase_launch(int n, long long* out, void* stream) {
    smem_chase_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(n, out);
    return (int)cudaGetLastError();
}
