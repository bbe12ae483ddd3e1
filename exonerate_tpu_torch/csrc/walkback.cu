// Traceback walk-back over the K4 plan-id cube, hand-written for Hopper.
//
// Replaces exonerate_tpu/engine/pallas_wavefront.py:_build_walkback
// (:1550; the per-pair jax.lax.while_loop :1564-1587, vmapped over the
// batch).  One thread per pair starts at its best end cell (query_end,
// target_end) in the END state and follows the winning plan ids back:
// each id names a transition whose advances step (i, j) back and whose
// input is the next state.  The walk stops on id 0 or after `cap` steps,
// and ends after a transition from START (ref: viterbi.c:342-392).  The
// output is the op list (end->start), its length and the start cell.
//
// What bounds it on the H100: latency.  A walk is a chain of dependent
// one-byte loads, one per step, scattered over a cube of ~100 MB per
// 2175^2 pair, so each step waits on a DRAM round trip; there is no
// parallelism inside a pair.  The design keeps everything else off the
// chain: the id tables (advances, input state, from-START flag) sit in
// shared memory, and the batch's walks run side by side, one per thread.
// For one pair this is a few thousand dependent loads, microseconds next
// to the wavefront that wrote the cube.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int MAX_IDS = 256;      // plan ids are uint8

__global__ void walkback_kernel(const uint8_t* tb, const int32_t* stats,
                                const int32_t* walk, int n_ids, int end_id,
                                int B, int D, int S, int W, int cap,
                                int32_t* ops, int32_t* res) {
    __shared__ int32_t s_aq[MAX_IDS], s_at[MAX_IDS], s_in[MAX_IDS],
        s_fs[MAX_IDS];
    for (int k = threadIdx.x; k < n_ids; k += blockDim.x) {
        s_aq[k] = walk[0 * n_ids + k];
        s_at[k] = walk[1 * n_ids + k];
        s_in[k] = walk[2 * n_ids + k];
        s_fs[k] = walk[3 * n_ids + k];
    }
    __syncthreads();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    // stats rows: score, query_end, target_end (wavefront output)
    int i = stats[1 * B + b], j = stats[2 * B + b], s = end_id, k = 0;
    const uint8_t* cube = tb + (size_t)b * D * S * W;
    while (true) {
        int d = i + j;
        d = d < 0 ? 0 : (d >= D ? D - 1 : d);
        const int ii = i < 0 ? 0 : (i >= W ? W - 1 : i);
        const int tid = cube[((size_t)d * S + s) * W + ii];
        if (tid == 0 || k >= cap) break;
        if (tid >= n_ids) {      // not a plan id: report an overlong walk
            k = cap;
            break;
        }
        ops[(size_t)b * cap + k] = tid;
        ++k;
        i -= s_aq[tid];
        j -= s_at[tid];
        s = s_in[tid];
        if (s_fs[tid]) break;
    }
    res[0 * B + b] = k;
    res[1 * B + b] = i;
    res[2 * B + b] = j;
}

}  // namespace

extern "C" int walkback_launch(const uint8_t* tb, const int32_t* stats,
                               const int32_t* walk, int n_ids, int end_id,
                               int B, int D, int S, int W, int cap,
                               int32_t* ops, int32_t* res, void* stream) {
    if (B <= 0) return 0;
    if (n_ids > MAX_IDS) return (int)cudaErrorInvalidValue;
    const int blocks = (B + THREADS - 1) / THREADS;
    walkback_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        tb, stats, walk, n_ids, end_id, B, D, S, W, cap, ops, res);
    return (int)cudaGetLastError();
}
