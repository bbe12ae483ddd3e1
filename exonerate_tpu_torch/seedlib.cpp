// seedlib: native seeding hot loops for exonerate-tpu.
//
// C++ implementation of the HSP seeding machine — the reference's hottest
// host-side loops (ref: src/comparison/hspset.c:700-1000: per-diagonal
// horizon dedup, end trimming, masked/unmasked x-drop extension, storing)
// — driven per (query, target, match-class) over a presorted seed list.
// The Python HspSet (exonerate_tpu_torch/seeds/hsp.py) is the behavioural
// specification; both implementations are cross-checked in tests.
//
// Build: g++ -O3 -shared -fPIC -o libseedlib.so seedlib.cpp

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t kImpossiblyLow = -987654321LL;

struct Params {
    const int32_t* q_idx;   // submat row index per query position
    int64_t qlen;
    const int32_t* t_idx;
    int64_t tlen;
    const int32_t* submat;  // [dim, dim]
    int64_t dim;
    const uint8_t* q_veto;  // optional per-query-pos CDS veto (may be null)
    const uint8_t* q_mask;  // softmask flags (may be null)
    const uint8_t* t_mask;
    int forbid_masked;
    int64_t qadv, tadv;
    int64_t seedlen, dropoff, threshold, seed_repeat;
};

struct Hsp {
    int64_t q, t, len, score, cobs;
};

inline int64_t cell_score(const Params& p, int64_t qp, int64_t tp) {
    if (p.q_veto && p.q_veto[qp]) return kImpossiblyLow;
    return p.submat[p.q_idx[qp] * p.dim + p.t_idx[tp]];
}

inline bool masked(const Params& p, int64_t qp, int64_t tp) {
    return (p.q_mask && p.q_mask[qp]) || (p.t_mask && p.t_mask[tp]);
}

// (ref: HSP_extend, hspset.c:748-815)
void extend(const Params& p, Hsp& h, bool forbid_masked) {
    int64_t maxscore = h.score, score = h.score;
    int64_t qp = h.q - p.qadv, tp = h.t - p.tadv;
    int64_t maxext = 0, ext = 1;
    for (; qp >= 0 && tp >= 0; ++ext) {
        if (forbid_masked && masked(p, qp, tp)) break;
        score += cell_score(p, qp, tp);
        if (maxscore <= score) {
            maxscore = score;
            maxext = ext;
        } else {
            if (score < 0) break;
            if (maxscore - score >= p.dropoff) break;
        }
        qp -= p.qadv;
        tp -= p.tadv;
    }
    qp = h.q + h.len * p.qadv;
    tp = h.t + h.len * p.tadv;
    h.q -= maxext * p.qadv;
    h.t -= maxext * p.tadv;
    h.len += maxext;
    score = maxscore;
    maxext = 0;
    for (ext = 1; qp + p.qadv <= p.qlen && tp + p.tadv <= p.tlen; ++ext) {
        if (forbid_masked && masked(p, qp, tp)) break;
        score += cell_score(p, qp, tp);
        if (maxscore <= score) {
            maxscore = score;
            maxext = ext;
        } else {
            if (score < 0) break;
            if (maxscore - score >= p.dropoff) break;
        }
        qp += p.qadv;
        tp += p.tadv;
    }
    h.len += maxext;
    h.score = maxscore;
}

// (ref: HSP_trim_ends, hspset.c:852-880)
void trim_ends(const Params& p, Hsp& h) {
    while (h.len > 0 && cell_score(p, h.q, h.t) <= 0) {
        h.q += p.qadv;
        h.t += p.tadv;
        --h.len;
    }
    while (h.len > 0) {
        int64_t qp = h.q + (h.len - 1) * p.qadv;
        int64_t tp = h.t + (h.len - 1) * p.tadv;
        if (cell_score(p, qp, tp) > 0) break;
        --h.len;
    }
}

void init_score(const Params& p, Hsp& h) {
    int64_t s = 0, qp = h.q, tp = h.t;
    for (int64_t k = 0; k < h.len; ++k) {
        s += cell_score(p, qp, tp);
        qp += p.qadv;
        tp += p.tadv;
    }
    h.score = s;
}

// (ref: HSP_find_cobs, hspset.c:426-441)
int64_t find_cobs(const Params& p, const Hsp& h) {
    int64_t s = 0, qp = h.q, tp = h.t;
    int64_t half = h.score >> 1;
    for (int64_t k = 0; k < h.len; ++k) {
        s += cell_score(p, qp, tp);
        if (s >= half) return k;
        qp += p.qadv;
        tp += p.tadv;
    }
    return h.len;
}

struct Horizon {
    int64_t end = 0, count = 0, diag = INT64_MIN;
};

}  // namespace

extern "C" {

// Process all seeds (in target-position order) against one pair.
// Returns the number of HSPs written into out (capacity cap).
int64_t seedlib_seed_all(
    const int32_t* q_idx, int64_t qlen, const int32_t* t_idx, int64_t tlen,
    const int32_t* submat, int64_t dim, const uint8_t* q_veto,
    const uint8_t* q_mask, const uint8_t* t_mask, int forbid_masked,
    int64_t qadv, int64_t tadv, int64_t seedlen, int64_t dropoff,
    int64_t threshold, int64_t seed_repeat, const int64_t* seeds_q,
    const int64_t* seeds_t, int64_t n_seeds, Hsp* out, int64_t cap) {
    Params p{q_idx, qlen, t_idx, tlen, submat, dim, q_veto,
             q_mask, t_mask, forbid_masked, qadv, tadv,
             seedlen, dropoff, threshold, seed_repeat};
    // horizon keyed by (section, qframe, tframe)
    // (ref: hspset.c:933-997, including the deliberate modulo-qlen
    // diagonal aliasing)
    std::unordered_map<int64_t, Horizon> horizon;
    int64_t n_out = 0;
    for (int64_t s = 0; s < n_seeds && n_out < cap; ++s) {
        int64_t query_start = seeds_q[s];
        int64_t target_start = seeds_t[s];
        int64_t diag_pos = target_start * qadv - query_start * tadv;
        int64_t qframe = query_start % qadv;
        int64_t tframe = target_start % tadv;
        int64_t section = ((diag_pos + qlen) % qlen + qlen) % qlen;
        int64_t key = (section * qadv + qframe) * tadv + tframe;
        Horizon& hz = horizon[key];
        if (seed_repeat > 1 && hz.diag != diag_pos + qlen) {
            hz.end = 0;
            hz.count = 0;
            hz.diag = diag_pos + qlen;
        }
        if (target_start < hz.end) continue;
        if (seed_repeat > 1) {
            if (++hz.count < seed_repeat) continue;
            hz.count = 0;
        }
        Hsp h{query_start, target_start, seedlen, 0, 0};
        trim_ends(p, h);
        init_score(p, h);
        if (h.score < 0) {
            // (ref: HSP_init, hspset.c:740-743): a negative initial
            // seed aborts the reference with a FATAL; report it back
            // so the caller raises the same error
            out[0] = h;
            return -2;
        }
        if (forbid_masked) {
            extend(p, h, true);
            if (h.score < threshold) {
                hz.end = h.t + h.len * tadv;
                continue;
            }
        }
        extend(p, h, false);
        hz.end = h.t + h.len * tadv;
        if (h.score < threshold) continue;
        h.cobs = 0;
        out[n_out++] = h;
    }
    // cobs at finalise (ref: HSPset_finalise, hspset.c:1123-1150)
    for (int64_t k = 0; k < n_out; ++k) {
        out[k].cobs = find_cobs(p, out[k]);
    }
    return n_out;
}

// BLAST-style word neighbourhood DFS (ref: WordHood_traverse,
// wordhood.c:321-341; spec: seeds/wordhood.py:neighbours).  Emits all
// base-n packed words scoring >= threshold against `word`, in the same
// ascending-member DFS order as the Python implementation.  Returns the
// count, or -1 when out_cap is too small (caller retries bigger).
int64_t wordhood_neighbours(const int32_t* matrix, int64_t n,
                            int64_t wordlen, const int32_t* word,
                            int64_t threshold, int64_t* out,
                            int64_t out_cap) {
    // suffix max bounds for pruning
    int64_t suffix_max[64];
    suffix_max[wordlen] = 0;
    for (int64_t i = wordlen - 1; i >= 0; --i) {
        int64_t mx = matrix[word[i] * n];
        for (int64_t c = 1; c < n; ++c) {
            int64_t v = matrix[word[i] * n + c];
            if (v > mx) mx = v;
        }
        suffix_max[i] = suffix_max[i + 1] + mx;
    }
    int64_t n_out = 0;
    // iterative DFS, ascending member order per position
    int64_t cstack[64];
    int64_t sstack[64];
    int64_t astack[64];
    int64_t pos = 0;
    cstack[0] = 0;
    sstack[0] = 0;
    astack[0] = 0;
    while (pos >= 0) {
        if (pos == wordlen) {
            if (sstack[pos] >= threshold) {
                if (n_out >= out_cap) return -1;
                out[n_out++] = astack[pos];
            }
            pos--;
            continue;
        }
        int64_t c = cstack[pos];
        if (c >= n) {
            pos--;
            continue;
        }
        cstack[pos] = c + 1;
        int64_t s = matrix[word[pos] * n + c];
        int64_t bound = threshold - sstack[pos] - suffix_max[pos + 1];
        if (s >= bound) {
            sstack[pos + 1] = sstack[pos] + s;
            astack[pos + 1] = astack[pos] * n + c;
            pos++;
            if (pos < wordlen) cstack[pos] = 0;
        }
    }
    return n_out;
}

}  // extern "C"
