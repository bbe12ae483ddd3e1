// sdplib: native seeded-DP scheduler for exonerate-tpu.
//
// C++ implementation of the SDP sparse scheduler pass — the default
// gapped-heuristic hot loop (ref: src/sdp/scheduler.c:700-1100
// Scheduler_Cell_process / Scheduler_Cell_assign, and the span
// freeze/thaw protocol scheduler.c:567-645).  The Python _Pass in
// exonerate_tpu_torch/engine/sdp.py is the behavioural specification; this
// file reproduces it operation-for-operation (iteration order,
// first-writer-wins ties, dropoff pruning, per-path max tracking,
// shadow lanes, boundary extraction) so that byte-golden outputs are
// identical whichever engine runs.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libsdplib.so sdplib.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t kNeg = -987654321LL;

// transition flags
constexpr int32_t F_SPAN_LOOP = 1;
constexpr int32_t F_MATCH = 2;
constexpr int32_t F_P_UNDER = 4;
constexpr int32_t F_P_OVER = 8;
constexpr int32_t F_REV_SHADOWED = 16;
constexpr int32_t F_FROM_START = 32;
constexpr int32_t F_TO_END = 64;

// score modes
constexpr int32_t G_NONE = 5;
constexpr int32_t G_CONST = 0;
constexpr int32_t G_QVEC = 1;
constexpr int32_t G_TVEC = 2;
constexpr int32_t G_FACTORED = 4;
constexpr int32_t G_QTSUM = 6;  // qvec[i] + tvec[j] (joint introns)

// shadow kinds
constexpr int32_t SK_NONE = 0;
constexpr int32_t SK_INTRON_WINDOW = 1;
constexpr int32_t SK_SPLIT_CODON = 2;

struct TransDesc {
    int32_t aq, at;
    int32_t in_id, out_id;
    int32_t flags;
    int32_t gmode;
    int32_t gval;          // G_CONST
    const int32_t* qvec;   // G_QVEC
    const int32_t* tvec;   // G_TVEC
    const int32_t* table;  // G_FACTORED (dim x dim)
    int32_t dim;
    const int32_t* q_idx;
    const int32_t* t_idx;
    const int32_t* q_over;  // may be null
    // shadow consumption
    int32_t shadow_kind;
    // intron window params
    int32_t iw_use_q, iw_use_t, iw_lane_q, iw_lane_t;
    int32_t iw_min, iw_max;
    // split codon params
    int32_t sc_phase, sc_q_is_dna, sc_t_is_dna, sc_on_q, sc_on_t;
    int32_t sc_lane_q, sc_lane_t;
    // shadow starts
    int32_t n_starts;
    int32_t starts_off;
    // span whose state == output (freeze at span loop), else -1
    int32_t span_id;
    // original model-order transition index (for traceback export)
    int32_t orig_idx;
    // minimum calc value can wrap NEG sources past INT32_MIN into a
    // large positive gint (stacked splice penalties, e.g. joint introns
    // under --forcegtag); such transitions must process IMPOSSIBLY_LOW
    // sources like the reference does (scheduler.c:1019 has no skip)
    int32_t can_wrap;
};

struct SpanDesc {
    int32_t state_id;
    int64_t min_q, max_q, min_t, max_t;
    int32_t qloop_orig, tloop_orig;  // original transition idx, -1 none
};

struct PassDesc {
    int32_t n_states, n_shadow, n_trans, n_spans;
    int32_t is_forward, use_boundary, has_traceback;
    int64_t qlen, tlen;        // region lengths
    int64_t rqs, rts;          // region absolute offsets
    int64_t dropoff;
    int64_t mta;               // max(model.max_target_advance, 1)
    const TransDesc* trans;    // reverse model order
    const SpanDesc* spans;
    // shadow starts flattened
    const int32_t* starts_des;
    const int32_t* starts_onq;
    const int32_t* const* starts_vec;  // per start: vec or null
    // split-codon shared arrays
    const int32_t* q_nt4;
    int64_t q_nt4_len;
    const int32_t* t_nt4;
    int64_t t_nt4_len;
    const int32_t* q_sym;
    int64_t q_sym_len;
    const int32_t* t_sym;
    int64_t t_sym_len;
    const int32_t* trans_idx;
    const int32_t* psub;
    int32_t psub_dim;
    // subopt blocked points CSR: sorted rows, per-row sorted qpos
    int32_t n_blocked_rows;
    const int64_t* blk_rows;
    const int64_t* blk_off;      // n_blocked_rows + 1
    const int64_t* blk_q;
    // seeds
    int32_t n_seeds;
    const int64_t* seed_pt;
    const int64_t* seed_pq;
    const int64_t* seed_id;
    const int64_t* seed_score;
    // terminal registration
    int32_t want_start_func;   // reverse non-boundary
    int32_t want_end_func;     // forward
    int32_t start_state_id, end_state_id;
    int32_t n_reg_seeds;       // number of logical seeds for terminals
};

struct Outputs {
    // per-registered-seed terminals (size n_reg_seeds)
    int64_t* term_score;
    int64_t* term_q;
    int64_t* term_t;
    int64_t* term_tb;
    // boundary triplets (reverse + boundary): grown internally
    std::vector<int64_t> boundary;  // (t, q, seed) triplets
    // traceback arena
    std::vector<int32_t> tb_trans;
    std::vector<int64_t> tb_len;
    std::vector<int64_t> tb_prev;
};

struct Cell {
    int64_t* score;
    int64_t* pmax;
    int64_t* seed;
    int64_t* tb;       // arena index, -1 none
    int64_t* shadow;   // n_states * n_shadow (may be unused)
    bool thaw;
};

class CellPool {
  public:
    CellPool(int n_states, int n_shadow)
        : n_states_(n_states), n_shadow_(n_shadow) {
        stride_ = n_states * 4 + n_states * n_shadow;
    }
    Cell* alloc(bool thaw) {
        if (free_.empty()) {
            blocks_.emplace_back(new int64_t[stride_ * kBlock]);
            cells_.emplace_back(new Cell[kBlock]);
            int64_t* base = blocks_.back();
            Cell* cb = cells_.back();
            for (int i = 0; i < kBlock; i++) {
                Cell& c = cb[i];
                int64_t* p = base + (int64_t)i * stride_;
                c.score = p;
                c.pmax = p + n_states_;
                c.seed = p + 2 * n_states_;
                c.tb = p + 3 * n_states_;
                c.shadow = p + 4 * n_states_;
                free_.push_back(&c);
            }
        }
        Cell* c = free_.back();
        free_.pop_back();
        for (int k = 0; k < n_states_; k++) {
            c->score[k] = kNeg;
            c->pmax[k] = 0;  // ref memset: unset pmax reads 0
            c->seed[k] = 0;
            c->tb[k] = -1;
        }
        if (n_shadow_)
            std::memset(c->shadow, 0,
                        sizeof(int64_t) * n_states_ * n_shadow_);
        c->thaw = thaw;
        return c;
    }
    void release(Cell* c) { free_.push_back(c); }
    ~CellPool() {
        for (auto* b : blocks_) delete[] b;
        for (auto* cb : cells_) delete[] cb;
    }

  private:
    static constexpr int kBlock = 1024;
    int n_states_, n_shadow_;
    int64_t stride_;
    std::vector<int64_t*> blocks_;
    std::vector<Cell*> cells_;
    std::vector<Cell*> free_;
};

struct SpanSeed {
    int64_t score, pmax, seed;
    int64_t tb;
    int64_t q_entry, t_entry;
    std::vector<int64_t> shadow;
};

// A sparse row: direct-mapped cell slots (index = pq - pq_min, the
// reference's Lookahead-ring role) plus a min-heap of pending keys
// used while the row is being processed (ascending-pq order with
// same-row insertions, matching the Python pending-merge).  Slot
// arrays are pooled and sparsely cleared via the `used` key list.
struct Row {
    std::vector<Cell*>* slots = nullptr;
    std::vector<int64_t> used;
    std::vector<int64_t> pending;
    bool processing = false;
};

class Pass {
  public:
    Pass(const PassDesc& d, Outputs& out) : d_(d), out_(out),
        pool_(d.n_states, d.n_shadow) {
        pq_min_ = d.is_forward ? 0 : -d.qlen;
        for (int i = 0; i < d_.n_spans; i++)
            span_by_state_[d_.spans[i].state_id] = i;
        span_curr_.assign(d_.n_spans, -1);
        for (int i = 0; i < d_.n_reg_seeds; i++) {
            out_.term_score[i] = kNeg;
            out_.term_q[i] = 0;
            out_.term_t[i] = 0;
            out_.term_tb[i] = -1;
        }
    }

    void run() {
        int64_t mta = d_.mta;
        int32_t si = 0;
        bool boundary_thaw = d_.is_forward && d_.use_boundary;
        while (true) {
            int64_t pt0;
            if (rows_.empty()) {
                if (si >= d_.n_seeds) break;
                pt0 = d_.seed_pt[si];
            } else {
                pt0 = rows_.begin()->first;
                if (si < d_.n_seeds && d_.seed_pt[si] < pt0)
                    pt0 = d_.seed_pt[si];
            }
            while (si < d_.n_seeds && d_.seed_pt[si] - pt0 <= mta) {
                seed_cell(d_.seed_pq[si], d_.seed_pt[si],
                          d_.seed_id[si], d_.seed_score[si],
                          boundary_thaw);
                si++;
            }
            auto it = rows_.find(pt0);
            if (it != rows_.end()) {
                process_row(pt0, *it->second);
                retire_row(pt0, *it->second);
                Row* r = it->second;
                for (int64_t key : r->used)
                    pool_.release((*r->slots)[key - pq_min_]);
                recycle_row(r);
                rows_.erase(it);
            }
        }
    }

  private:
    const PassDesc& d_;
    Outputs& out_;
    CellPool pool_;
    std::map<int64_t, Row*> rows_;
    std::vector<std::vector<Cell*>*> slot_pool_;
    std::vector<Row*> row_pool_;
    int64_t pq_min_ = 0;
    std::unordered_map<int32_t, int32_t> span_by_state_;
    // span freeze cache: key = span_id * 2^40 + (q + 2^38)
    std::unordered_map<int64_t, SpanSeed> span_cache_;
    std::vector<int64_t> span_curr_;  // per-span curr cache KEY (-1 = none)

    Row* get_row(int64_t pt) {
        auto it = rows_.find(pt);
        if (it != rows_.end()) return it->second;
        Row* r;
        if (!row_pool_.empty()) {
            r = row_pool_.back();
            row_pool_.pop_back();
        } else {
            r = new Row();
        }
        if (slot_pool_.empty()) {
            r->slots = new std::vector<Cell*>(d_.qlen + 1, nullptr);
        } else {
            r->slots = slot_pool_.back();
            slot_pool_.pop_back();
        }
        rows_[pt] = r;
        return r;
    }

    void recycle_row(Row* r) {
        for (int64_t key : r->used)
            (*r->slots)[key - pq_min_] = nullptr;
        r->used.clear();
        r->pending.clear();
        r->processing = false;
        slot_pool_.push_back(r->slots);
        r->slots = nullptr;
        row_pool_.push_back(r);
    }

    Cell* get_cell(Row& row, int64_t pq, bool thaw, bool* created) {
        Cell*& slot = (*row.slots)[pq - pq_min_];
        if (slot != nullptr) {
            *created = false;
            return slot;
        }
        Cell* c = pool_.alloc(thaw);
        slot = c;
        row.used.push_back(pq);
        if (row.processing) {
            row.pending.push_back(pq);
            std::push_heap(row.pending.begin(), row.pending.end(),
                           std::greater<int64_t>());
        }
        *created = true;
        return c;
    }

    void seed_cell(int64_t pq, int64_t pt, int64_t sid, int64_t sscore,
                   bool thaw) {
        Row& row = *get_row(pt);
        bool created;
        Cell* cell = get_cell(row, pq, thaw, &created);
        if (thaw) cell->thaw = true;
        int32_t state_id = d_.is_forward ? d_.start_state_id
                                         : d_.end_state_id;
        cell->score[state_id] = sscore;
        cell->pmax[state_id] = sscore;
        cell->seed[state_id] = sid;
        cell->tb[state_id] = -1;
        if (d_.n_shadow)
            std::memset(cell->shadow + (int64_t)state_id * d_.n_shadow,
                        0, sizeof(int64_t) * d_.n_shadow);
    }

    int64_t tb_add(int32_t trans_orig, int64_t len, int64_t prev) {
        out_.tb_trans.push_back(trans_orig);
        out_.tb_len.push_back(len);
        out_.tb_prev.push_back(prev);
        return (int64_t)out_.tb_trans.size() - 1;
    }

    void retire_row(int64_t pt, Row& row) {
        // (ref: boundary extraction, scheduler.c:965-1000)
        if (d_.is_forward || !d_.use_boundary) return;
        std::vector<int64_t> keys(row.used);
        std::sort(keys.begin(), keys.end());
        std::vector<int64_t> pts;  // (q, seed) pairs, later reversed
        for (int64_t key : keys) {  // ascending pq
            Cell* cell = (*row.slots)[key - pq_min_];
            if (cell->score[d_.start_state_id] >= 0) {
                pts.push_back(-key);
                pts.push_back(cell->seed[d_.start_state_id]);
            } else {
                for (int i = 0; i < d_.n_spans; i++) {
                    int32_t sid = d_.spans[i].state_id;
                    if (cell->score[sid] > 0) {
                        pts.push_back(-key);
                        pts.push_back(cell->seed[sid]);
                        break;
                    }
                }
            }
        }
        // emit reversed (ascending original q) as (t, q, seed)
        for (int64_t i = (int64_t)pts.size() - 2; i >= 0; i -= 2) {
            out_.boundary.push_back(-pt);
            out_.boundary.push_back(pts[i]);
            out_.boundary.push_back(pts[i + 1]);
        }
    }

    // subopt: is (abs q) blocked on abs target row?
    const int64_t* blocked_begin_ = nullptr;
    const int64_t* blocked_end_ = nullptr;

    void set_blocked_row(int64_t abs_t) {
        blocked_begin_ = blocked_end_ = nullptr;
        if (!d_.n_blocked_rows) return;
        const int64_t* lo = d_.blk_rows;
        const int64_t* hi = d_.blk_rows + d_.n_blocked_rows;
        const int64_t* p = std::lower_bound(lo, hi, abs_t);
        if (p == hi || *p != abs_t) return;
        int64_t k = p - lo;
        blocked_begin_ = d_.blk_q + d_.blk_off[k];
        blocked_end_ = d_.blk_q + d_.blk_off[k + 1];
    }

    bool is_blocked(int64_t abs_q) const {
        if (blocked_begin_ == nullptr) return false;
        const int64_t* p =
            std::lower_bound(blocked_begin_, blocked_end_, abs_q);
        return p != blocked_end_ && *p == abs_q;
    }

    void process_row(int64_t pt, Row& row) {
        set_blocked_row(d_.rts + (d_.is_forward ? pt : -pt));
        // ascending pq via a min-heap; cells inserted at higher pq
        // during processing are pushed and visited in order (matches
        // the Python pending-merge)
        row.processing = true;
        row.pending = row.used;
        std::make_heap(row.pending.begin(), row.pending.end(),
                       std::greater<int64_t>());
        while (!row.pending.empty()) {
            std::pop_heap(row.pending.begin(), row.pending.end(),
                          std::greater<int64_t>());
            int64_t pq = row.pending.back();
            row.pending.pop_back();
            process_cell(pq, pt, (*row.slots)[pq - pq_min_], row);
        }
        row.processing = false;
    }

    int64_t shadow_lane(const Cell* cell, int32_t ip,
                        int32_t lane) const {
        if (lane < 0 || !d_.n_shadow) return 0;
        return cell->shadow[(int64_t)ip * d_.n_shadow + lane];
    }

    int64_t split_codon_score(const TransDesc& t, const Cell* cell,
                              int32_t ip, int64_t qpos,
                              int64_t tpos) const {
        // (ref: Phase_CalcFunc, phase.c:196-230; spec:
        // model/phase.py:_make_split_shadow_fn)
        bool valid = true;
        int32_t phase = t.sc_phase;
        if (t.sc_q_is_dna) {
            if (t.sc_on_q)
                valid = valid &&
                        (shadow_lane(cell, ip, t.sc_lane_q) >= phase);
            else
                valid = valid && (qpos >= phase);
        }
        if (t.sc_t_is_dna) {
            if (t.sc_on_t)
                valid = valid &&
                        (shadow_lane(cell, ip, t.sc_lane_t) >= phase);
            else
                valid = valid && (tpos >= phase);
        }
        auto codon_positions = [phase](int64_t pos, int64_t start,
                                       bool has_intron, int64_t* p) {
            if (phase == 1) {
                p[0] = has_intron ? start - 1 : pos - 1;
                p[1] = pos;
                p[2] = pos + 1;
            } else {
                p[0] = has_intron ? start - 2 : pos - 2;
                p[1] = has_intron ? start - 1 : pos - 1;
                p[2] = pos;
            }
        };
        auto codon_index = [](const int32_t* nt4, int64_t n,
                              const int32_t* trans_idx,
                              const int64_t* p) {
            auto clip = [n](int64_t x) {
                return x < 0 ? 0 : (x >= n ? n - 1 : x);
            };
            int32_t packed = nt4[clip(p[0])] | (nt4[clip(p[1])] << 4) |
                             (nt4[clip(p[2])] << 8);
            return trans_idx[packed];
        };
        int32_t qi, ti;
        if (t.sc_q_is_dna) {
            int64_t qstart =
                t.sc_on_q ? shadow_lane(cell, ip, t.sc_lane_q) : 0;
            int64_t p[3];
            codon_positions(qpos, qstart, t.sc_on_q, p);
            qi = codon_index(d_.q_nt4, d_.q_nt4_len, d_.trans_idx, p);
        } else {
            int64_t q = qpos < 0 ? 0
                        : (qpos >= d_.q_sym_len ? d_.q_sym_len - 1
                                                : qpos);
            qi = d_.q_sym[q];
        }
        if (t.sc_t_is_dna) {
            int64_t tstart =
                t.sc_on_t ? shadow_lane(cell, ip, t.sc_lane_t) : 0;
            int64_t p[3];
            codon_positions(tpos, tstart, t.sc_on_t, p);
            ti = codon_index(d_.t_nt4, d_.t_nt4_len, d_.trans_idx, p);
        } else {
            int64_t tt = tpos < 0 ? 0
                         : (tpos >= d_.t_sym_len ? d_.t_sym_len - 1
                                                 : tpos);
            ti = d_.t_sym[tt];
        }
        if (!valid) return kNeg;
        return d_.psub[qi * d_.psub_dim + ti];
    }

    void span_submit(int32_t span_i, Cell* cell, int32_t ip,
                     int64_t src_q, int64_t src_t) {
        const SpanDesc& sp = d_.spans[span_i];
        if (!sp.max_t) return;
        int64_t key = ((int64_t)span_i << 40) | (src_q + (1LL << 38));
        auto it = span_cache_.find(key);
        if (it != span_cache_.end() &&
            it->second.score > cell->score[ip])
            return;
        SpanSeed& s = span_cache_[key];
        s.score = cell->score[ip];
        s.pmax = cell->pmax[ip];
        s.seed = cell->seed[ip];
        s.tb = cell->tb[ip];
        s.q_entry = src_q;
        s.t_entry = src_t;
        if (d_.n_shadow) {
            s.shadow.assign(
                cell->shadow + (int64_t)ip * d_.n_shadow,
                cell->shadow + (int64_t)(ip + 1) * d_.n_shadow);
        }
    }

    void span_thaw(int32_t span_i, Cell* cell, int32_t ip,
                   int64_t q_pos, int64_t t_pos) {
        const SpanDesc& sp = d_.spans[span_i];
        // curr is the KEY of a live cache slot (-1 = none): the
        // reference's span_data->curr_span_seed is a POINTER into the
        // cache and submits copy IN PLACE (Scheduler_SpanSeed_copy,
        // scheduler.c:631-638), so a tie-replacing re-freeze is
        // visible through curr — a value copy here left curr stale and
        // shifted the freeze/thaw split of ner crossings (cigar-level
        // parity; vulgar/score unaffected)
        int64_t curr_key = span_curr_[span_i];
        SpanSeed* curr = nullptr;
        if (curr_key >= 0) {
            auto itc = span_cache_.find(curr_key);
            if (itc != span_cache_.end()) curr = &itc->second;
            else curr_key = -1;
        }
        // expire curr (ref: Scheduler_SpanData_get_curr)
        if (curr && (curr->q_entry > q_pos ||
                     curr->q_entry + sp.max_q < q_pos ||
                     curr->t_entry + sp.max_t < t_pos)) {
            curr = nullptr;
            curr_key = -1;
        }
        int64_t key = ((int64_t)span_i << 40) | (q_pos + (1LL << 38));
        auto it = span_cache_.find(key);
        if (it != span_cache_.end()) {
            if (it->second.t_entry + sp.max_t >= t_pos) {
                if (!curr || curr->score < it->second.score) {
                    curr = &it->second;
                    curr_key = key;
                }
            } else {
                if (curr_key == key) {
                    curr = nullptr;
                    curr_key = -1;
                }
                span_cache_.erase(it);
            }
        }
        span_curr_[span_i] = curr_key;
        if (curr && cell->score[ip] < curr->score) {
            cell->score[ip] = curr->score;
            cell->pmax[ip] = curr->pmax;
            cell->seed[ip] = curr->seed;
            int64_t tb = curr->tb;
            int64_t qdiff = q_pos - curr->q_entry;
            int64_t tdiff = t_pos - curr->t_entry;
            if (qdiff) tb = tb_add(sp.qloop_orig, qdiff, tb);
            if (tdiff) tb = tb_add(sp.tloop_orig, tdiff, tb);
            cell->tb[ip] = tb;
            if (d_.n_shadow && !curr->shadow.empty())
                std::memcpy(
                    cell->shadow + (int64_t)ip * d_.n_shadow,
                    curr->shadow.data(),
                    sizeof(int64_t) * d_.n_shadow);
        }
    }

    void process_cell(int64_t pq, int64_t pt, Cell* cell, Row& row) {
        bool is_forward = d_.is_forward;
        bool use_boundary = d_.use_boundary;
        int64_t src_q = is_forward ? pq : -pq;
        int64_t src_t = is_forward ? pt : -pt;
        Row* dst_rows[4] = {&row, nullptr, nullptr, nullptr};
        for (int32_t k = 0; k < d_.n_trans; k++) {
            const TransDesc& t = d_.trans[k];
            if (t.flags & F_SPAN_LOOP) {
                // (ref: scheduler.c:891-922)
                if (is_forward && use_boundary && t.span_id >= 0 &&
                    cell->score[t.in_id] >= 0)
                    span_submit(t.span_id, cell, t.in_id, src_q, src_t);
                continue;
            }
            int64_t dst_q, dst_t, calc_q, calc_t;
            int32_t ip, op;
            if (is_forward) {
                dst_q = src_q + t.aq;
                dst_t = src_t + t.at;
                if (dst_q > d_.qlen || dst_t > d_.tlen) continue;
                ip = t.in_id;
                op = t.out_id;
                if (use_boundary && cell->thaw) {
                    auto sit = span_by_state_.find(t.in_id);
                    if (sit != span_by_state_.end())
                        span_thaw(sit->second, cell, ip, src_q, src_t);
                }
                calc_q = src_q;
                calc_t = src_t;
            } else {
                dst_q = src_q - t.aq;
                dst_t = src_t - t.at;
                if (dst_q < 0 || dst_t < 0) continue;
                ip = t.out_id;
                op = t.in_id;
                calc_q = dst_q;
                calc_t = dst_t;
            }
            int64_t src_score = cell->score[ip];
            if (src_score <= kNeg &&
                !(t.can_wrap &&
                  !(!is_forward && (t.flags & F_REV_SHADOWED))))
                continue;
            int64_t tscore;
            if (t.gmode == G_NONE ||
                (!is_forward && (t.flags & F_REV_SHADOWED))) {
                tscore = 0;  // (ref: scheduler.c:1008-1014)
            } else {
                switch (t.gmode) {
                    case G_CONST:
                        tscore = t.gval;
                        break;
                    case G_QVEC:
                        tscore = t.qvec[calc_q];
                        break;
                    case G_TVEC:
                        tscore = t.tvec[calc_t];
                        break;
                    case G_FACTORED:
                        if (t.q_over && t.q_over[calc_q])
                            tscore = t.q_over[calc_q];
                        else
                            tscore = t.table[t.q_idx[calc_q] * t.dim +
                                             t.t_idx[calc_t]];
                        break;
                    case G_QTSUM:
                        tscore = (int64_t)t.qvec[calc_q] +
                                 t.tvec[calc_t];
                        break;
                    default:
                        tscore = 0;
                }
                if (t.shadow_kind == SK_INTRON_WINDOW) {
                    // (ref: Intron_CalcFunc !is_pre, intron.c:147-158)
                    int64_t abs_q = d_.rqs + calc_q;
                    int64_t abs_t = d_.rts + calc_t;
                    bool bad = false;
                    if (t.iw_use_q) {
                        int64_t len = abs_q -
                            shadow_lane(cell, ip, t.iw_lane_q) + 2;
                        bad |= (len < t.iw_min) || (len > t.iw_max);
                    }
                    if (t.iw_use_t) {
                        int64_t len = abs_t -
                            shadow_lane(cell, ip, t.iw_lane_t) + 2;
                        bad |= (len < t.iw_min) || (len > t.iw_max);
                    }
                    if (bad) tscore = kNeg;
                } else if (t.shadow_kind == SK_SPLIT_CODON) {
                    tscore = split_codon_score(t, cell, ip,
                                               d_.rqs + calc_q,
                                               d_.rts + calc_t);
                }
            }
            int64_t max_score = cell->pmax[ip];
            int64_t seed_id = cell->seed[ip];
            // C4_Score is a 32-bit gint: the add and the dropoff
            // subtraction WRAP, and the clamps test the wrapped value
            // (ref: scheduler.c:1019-1024) — two stacked splice
            // penalties wrap POSITIVE past the UNDERFLOW clamp
            int64_t dst_score =
                (int64_t)(int32_t)(uint32_t)(src_score + tscore);
            if ((t.flags & F_P_UNDER) && dst_score < kNeg)
                dst_score = kNeg;
            if ((t.flags & F_P_OVER) && dst_score > -kNeg)
                dst_score = -kNeg;
            if (is_forward && dst_score < 0) continue;
            if ((int64_t)(int32_t)(uint32_t)(max_score - dst_score)
                > d_.dropoff) continue;
            if ((t.flags & F_MATCH) && is_blocked(d_.rqs + src_q))
                continue;
            int64_t dpq = pq + t.aq;
            Row* drow = dst_rows[t.at];
            if (drow == nullptr)
                drow = dst_rows[t.at] = get_row(pt + t.at);
            bool created;
            Cell* dcell = get_cell(*drow, dpq, false, &created);
            if (!created && dst_score <= dcell->score[op])
                continue;  // keep existing on ties (scheduler.c:1048)
            // assign (ref: Scheduler_Cell_assign, scheduler.c:763-830)
            dcell->score[op] = dst_score;
            dcell->seed[op] = seed_id;
            if (d_.has_traceback)
                dcell->tb[op] = tb_add(t.orig_idx, 1, cell->tb[ip]);
            if (is_forward && d_.n_shadow) {
                int64_t* dst_sh =
                    dcell->shadow + (int64_t)op * d_.n_shadow;
                if (dst_sh != cell->shadow + (int64_t)ip * d_.n_shadow)
                    std::memcpy(dst_sh,
                                cell->shadow + (int64_t)ip * d_.n_shadow,
                                sizeof(int64_t) * d_.n_shadow);
                for (int32_t s = 0; s < t.n_starts; s++) {
                    int32_t off = t.starts_off + s;
                    int32_t des = d_.starts_des[off];
                    const int32_t* vec = d_.starts_vec[off];
                    if (vec != nullptr) {
                        dst_sh[des] = vec[d_.starts_onq[off] ? src_q
                                                             : src_t];
                    } else {
                        dst_sh[des] = d_.starts_onq[off]
                                          ? d_.rqs + src_q
                                          : d_.rts + src_t;
                    }
                }
            }
            if (dst_score < max_score) {
                dcell->pmax[op] = max_score;
            } else {
                dcell->pmax[op] = dst_score;
                if (d_.want_start_func && (t.flags & F_FROM_START)) {
                    if (out_.term_score[seed_id] < dst_score) {
                        out_.term_score[seed_id] = dst_score;
                        out_.term_q[seed_id] = dst_q;
                        out_.term_t[seed_id] = dst_t;
                        out_.term_tb[seed_id] = dcell->tb[op];
                    }
                }
                if (d_.want_end_func && (t.flags & F_TO_END)) {
                    if (out_.term_score[seed_id] < dst_score) {
                        out_.term_score[seed_id] = dst_score;
                        out_.term_q[seed_id] = dst_q;
                        out_.term_t[seed_id] = dst_t;
                        out_.term_tb[seed_id] = dcell->tb[op];
                    }
                }
            }
        }
    }
};

// ---------------------------------------------------------------------
// Dense Viterbi interpreter (ref: Viterbi_interpreted, viterbi.c:655-837;
// spec: engine/reference.py:viterbi).  Same calc-descriptor vocabulary
// as the scheduler; modes score/region/path; first-max tie-breaking,
// scope masks, shadow lanes, subopt blocking, protect clamps.
// ---------------------------------------------------------------------

constexpr int32_t SCOPE_ANYWHERE = 0;
constexpr int32_t SCOPE_EDGE = 1;
constexpr int32_t SCOPE_QUERY = 2;
constexpr int32_t SCOPE_TARGET = 3;
constexpr int32_t SCOPE_CORNER = 4;

inline bool scope_ok_start(int32_t scope, int64_t i, int64_t j) {
    switch (scope) {
        case SCOPE_ANYWHERE: return true;
        case SCOPE_CORNER: return i == 0 && j == 0;
        case SCOPE_EDGE: return i == 0 || j == 0;
        case SCOPE_QUERY: return i == 0;
        case SCOPE_TARGET: return j == 0;
    }
    return false;
}

inline bool scope_ok_end(int32_t scope, int64_t i, int64_t j,
                         int64_t qlen, int64_t tlen) {
    switch (scope) {
        case SCOPE_ANYWHERE: return true;
        case SCOPE_CORNER: return i == qlen && j == tlen;
        case SCOPE_EDGE: return i == qlen || j == tlen;
        case SCOPE_QUERY: return i == qlen;
        case SCOPE_TARGET: return j == tlen;
    }
    return false;
}

struct ViterbiCtx {
    const PassDesc* d;          // reuses calc/shadow/blocked plumbing
    int32_t mode;               // 0 score, 1 region, 2 path
    int32_t start_scope, end_scope;
    int32_t start_id, end_id;
};

// calc score at source cell (ci, cj) with src lanes (may be null)
inline int64_t viterbi_calc_score(const ViterbiCtx& vc,
                                  const TransDesc& t,
                                  const int64_t* src_lanes,
                                  int64_t ci, int64_t cj) {
    const PassDesc& d = *vc.d;
    int64_t tscore;
    switch (t.gmode) {
        case G_NONE: return 0;
        case G_CONST: tscore = t.gval; break;
        case G_QVEC: tscore = t.qvec[ci]; break;
        case G_TVEC: tscore = t.tvec[cj]; break;
        case G_QTSUM:
            tscore = (int64_t)t.qvec[ci] + t.tvec[cj];
            break;
        case G_FACTORED:
            if (t.q_over && t.q_over[ci])
                tscore = t.q_over[ci];
            else
                tscore = t.table[t.q_idx[ci] * t.dim + t.t_idx[cj]];
            break;
        default: tscore = 0;
    }
    auto lane = [&](int32_t l) -> int64_t {
        return (src_lanes && l >= 0) ? src_lanes[l] : 0;
    };
    if (t.shadow_kind == SK_INTRON_WINDOW) {
        int64_t abs_q = d.rqs + ci;
        int64_t abs_t = d.rts + cj;
        bool bad = false;
        if (t.iw_use_q) {
            int64_t len = abs_q - lane(t.iw_lane_q) + 2;
            bad |= (len < t.iw_min) || (len > t.iw_max);
        }
        if (t.iw_use_t) {
            int64_t len = abs_t - lane(t.iw_lane_t) + 2;
            bad |= (len < t.iw_min) || (len > t.iw_max);
        }
        if (bad) tscore = kNeg;
    } else if (t.shadow_kind == SK_SPLIT_CODON) {
        // identical logic to Pass::split_codon_score, on raw lanes
        bool valid = true;
        int32_t phase = t.sc_phase;
        int64_t qpos = d.rqs + ci, tpos = d.rts + cj;
        if (t.sc_q_is_dna)
            valid &= t.sc_on_q ? (lane(t.sc_lane_q) >= phase)
                               : (qpos >= phase);
        if (t.sc_t_is_dna)
            valid &= t.sc_on_t ? (lane(t.sc_lane_t) >= phase)
                               : (tpos >= phase);
        auto codon_positions = [phase](int64_t pos, int64_t start,
                                       bool has_intron, int64_t* p) {
            if (phase == 1) {
                p[0] = has_intron ? start - 1 : pos - 1;
                p[1] = pos;
                p[2] = pos + 1;
            } else {
                p[0] = has_intron ? start - 2 : pos - 2;
                p[1] = has_intron ? start - 1 : pos - 1;
                p[2] = pos;
            }
        };
        auto codon_index = [](const int32_t* nt4, int64_t n,
                              const int32_t* trans_idx,
                              const int64_t* p) {
            auto clip = [n](int64_t x) {
                return x < 0 ? 0 : (x >= n ? n - 1 : x);
            };
            int32_t packed = nt4[clip(p[0])] | (nt4[clip(p[1])] << 4) |
                             (nt4[clip(p[2])] << 8);
            return trans_idx[packed];
        };
        int32_t qi, ti;
        if (t.sc_q_is_dna) {
            int64_t qstart = t.sc_on_q ? lane(t.sc_lane_q) : 0;
            int64_t p[3];
            codon_positions(qpos, qstart, t.sc_on_q, p);
            qi = codon_index(d.q_nt4, d.q_nt4_len, d.trans_idx, p);
        } else {
            int64_t q = qpos < 0 ? 0
                        : (qpos >= d.q_sym_len ? d.q_sym_len - 1
                                               : qpos);
            qi = d.q_sym[q];
        }
        if (t.sc_t_is_dna) {
            int64_t tstart = t.sc_on_t ? lane(t.sc_lane_t) : 0;
            int64_t p[3];
            codon_positions(tpos, tstart, t.sc_on_t, p);
            ti = codon_index(d.t_nt4, d.t_nt4_len, d.trans_idx, p);
        } else {
            int64_t tt = tpos < 0 ? 0
                         : (tpos >= d.t_sym_len ? d.t_sym_len - 1
                                                : tpos);
            ti = d.t_sym[tt];
        }
        tscore = valid ? d.psub[qi * d.psub_dim + ti] : kNeg;
    }
    return tscore;
}

}  // namespace

extern "C" {

// Dense Viterbi (ref: Viterbi_interpreted).  Reuses sdp_run_pass's
// parameter/tmeta layout with transitions in MODEL order.
// vparams: [mode, start_scope, end_scope, start_id, end_id]
// Outputs: res[5] = {score, q_start, t_start, q_end, t_end};
// path mode: path_out receives orig transition indices end->start
// reversed to start->end by the caller; returns path length (or the
// required capacity as a negative number if path_cap too small);
// score/region modes return 0, "no end reached" returns INT64_MIN.
int64_t c4_viterbi(
    const int64_t* params, const int32_t* tmeta,
    const int32_t* const* t_qvec, const int32_t* const* t_tvec,
    const int32_t* const* t_table, const int32_t* const* t_qidx,
    const int32_t* const* t_tidx, const int32_t* const* t_qover,
    const int32_t* starts_des, const int32_t* starts_onq,
    const int32_t* const* starts_vec,
    const int32_t* q_nt4, const int32_t* t_nt4, const int32_t* q_sym,
    const int32_t* t_sym, const int32_t* trans_idx, const int32_t* psub,
    const int64_t* blk_rows, const int64_t* blk_off,
    const int64_t* blk_q, const int64_t* vparams, int64_t* res,
    int32_t* path_out, int64_t path_cap) {
    PassDesc d;
    std::memset(&d, 0, sizeof(d));
    d.n_states = (int32_t)params[0];
    d.n_shadow = (int32_t)params[1];
    d.n_trans = (int32_t)params[2];
    d.qlen = params[7];
    d.tlen = params[8];
    d.rqs = params[9];
    d.rts = params[10];
    d.n_blocked_rows = (int32_t)params[13];
    d.q_nt4_len = params[20];
    d.t_nt4_len = params[21];
    d.q_sym_len = params[22];
    d.t_sym_len = params[23];
    d.psub_dim = (int32_t)params[24];
    std::vector<TransDesc> trans(d.n_trans);
    int64_t mta = 1;
    for (int32_t i = 0; i < d.n_trans; i++) {
        const int32_t* m = tmeta + (int64_t)i * 27;
        TransDesc& t = trans[i];
        t.aq = m[0]; t.at = m[1]; t.in_id = m[2]; t.out_id = m[3];
        t.flags = m[4]; t.gmode = m[5]; t.gval = m[6]; t.dim = m[7];
        t.shadow_kind = m[8];
        t.iw_use_q = m[9]; t.iw_use_t = m[10];
        t.iw_lane_q = m[11]; t.iw_lane_t = m[12];
        t.iw_min = m[13]; t.iw_max = m[14];
        t.sc_phase = m[15]; t.sc_q_is_dna = m[16];
        t.sc_t_is_dna = m[17]; t.sc_on_q = m[18]; t.sc_on_t = m[19];
        t.sc_lane_q = m[20]; t.sc_lane_t = m[21];
        t.n_starts = m[22]; t.starts_off = m[23];
        t.span_id = m[24]; t.orig_idx = m[25]; t.can_wrap = m[26];
        t.qvec = t_qvec[i]; t.tvec = t_tvec[i]; t.table = t_table[i];
        t.q_idx = t_qidx[i]; t.t_idx = t_tidx[i]; t.q_over = t_qover[i];
        if (t.at > mta) mta = t.at;
    }
    d.starts_des = starts_des;
    d.starts_onq = starts_onq;
    d.starts_vec = starts_vec;
    d.q_nt4 = q_nt4; d.t_nt4 = t_nt4; d.q_sym = q_sym; d.t_sym = t_sym;
    d.trans_idx = trans_idx; d.psub = psub;
    d.blk_rows = blk_rows; d.blk_off = blk_off; d.blk_q = blk_q;

    ViterbiCtx vc;
    vc.d = &d;
    vc.mode = (int32_t)vparams[0];
    vc.start_scope = (int32_t)vparams[1];
    vc.end_scope = (int32_t)vparams[2];
    vc.start_id = (int32_t)vparams[3];
    vc.end_id = (int32_t)vparams[4];
    bool want_extra = vc.mode >= 1;
    bool want_path = vc.mode == 2;
    int32_t n_shadow = d.n_shadow;
    int32_t n_extra = n_shadow + (want_extra ? 2 : 0);
    int32_t rs_q = n_shadow, rs_t = n_shadow + 1;  // only if want_extra
    int64_t cell_sz = 1 + n_extra;
    int64_t qlen = d.qlen, tlen = d.tlen;
    int64_t row_sz = (qlen + 1) * d.n_states * cell_sz;
    std::vector<int64_t> rowbuf((mta + 1) * row_sz, kNeg);
    std::vector<int64_t*> rows(mta + 1);
    for (int64_t r = 0; r <= mta; r++) rows[r] = rowbuf.data() + r * row_sz;
    std::vector<int16_t> tb;
    if (want_path) tb.assign((qlen + 1) * (tlen + 1) * d.n_states, 0);
    std::vector<uint8_t> state_is_set(d.n_states);
    std::vector<int64_t> best_cell(cell_sz, kNeg);
    int64_t best_score = kNeg, best_i = 0, best_j = 0;
    bool end_is_set = false;

    // subopt row lookup
    auto blocked_row = [&](int64_t abs_t, const int64_t** lo,
                           const int64_t** hi) {
        *lo = *hi = nullptr;
        if (!d.n_blocked_rows) return;
        const int64_t* rlo = d.blk_rows;
        const int64_t* rhi = d.blk_rows + d.n_blocked_rows;
        const int64_t* p = std::lower_bound(rlo, rhi, abs_t);
        if (p == rhi || *p != abs_t) return;
        int64_t k = p - rlo;
        *lo = d.blk_q + d.blk_off[k];
        *hi = d.blk_q + d.blk_off[k + 1];
    };

    for (int64_t j = 0; j <= tlen; j++) {
        int64_t* row0 = rows[0];
        std::fill(row0, row0 + row_sz, kNeg);
        const int64_t *blo, *bhi;
        blocked_row(d.rts + j, &blo, &bhi);
        for (int64_t i = 0; i <= qlen; i++) {
            std::fill(state_is_set.begin(), state_is_set.end(), 0);
            int64_t* cell = row0 + i * d.n_states * cell_sz;
            for (int64_t c = 0; c < d.n_states * cell_sz; c++)
                cell[c] = kNeg;
            for (int32_t k = 0; k < d.n_trans; k++) {
                const TransDesc& t = trans[k];
                int64_t si = i - t.aq, sj = j - t.at;
                if (si < 0 || sj < 0) continue;
                if (t.flags & F_FROM_START) {
                    if (!scope_ok_start(vc.start_scope, si, sj))
                        continue;
                }
                if (t.flags & F_TO_END) {
                    if (!scope_ok_end(vc.end_scope, i, j, qlen, tlen))
                        continue;
                }
                if ((t.flags & F_MATCH) && blo != nullptr) {
                    const int64_t* p =
                        std::lower_bound(blo, bhi, d.rqs + i);
                    if (p != bhi && *p == d.rqs + i) continue;
                }
                const int64_t* src = nullptr;
                int64_t base = 0;
                if (t.flags & F_FROM_START) {
                    base = 0;
                } else {
                    src = rows[t.at] + si * d.n_states * cell_sz +
                          t.in_id * cell_sz;
                    base = src[0];
                }
                int64_t tscore = viterbi_calc_score(
                    vc, t, src ? src + 1 : nullptr, si, sj);
                int64_t val = base + tscore;
                if ((t.flags & F_P_UNDER) && val < kNeg) val = kNeg;
                if ((t.flags & F_P_OVER) && val > -kNeg) val = -kNeg;
                int64_t* dst = cell + t.out_id * cell_sz;
                if (state_is_set[t.out_id] && dst[0] >= val) continue;
                state_is_set[t.out_id] = 1;
                dst[0] = val;
                if (n_extra) {
                    if (src != nullptr) {
                        for (int32_t l = 1; l < cell_sz; l++)
                            dst[l] = src[l];
                    } else {
                        for (int32_t l = 1; l < cell_sz; l++)
                            dst[l] = 0;
                    }
                    if ((t.flags & F_FROM_START) && want_extra) {
                        dst[1 + rs_q] = si;
                        dst[1 + rs_t] = sj;
                    }
                    for (int32_t s2 = 0; s2 < t.n_starts; s2++) {
                        int32_t off = t.starts_off + s2;
                        int32_t des = d.starts_des[off];
                        const int32_t* vec = d.starts_vec[off];
                        if (vec != nullptr)
                            dst[1 + des] =
                                vec[d.starts_onq[off] ? si : sj];
                        else
                            dst[1 + des] = d.starts_onq[off]
                                               ? d.rqs + si
                                               : d.rts + sj;
                    }
                }
                if (want_path)
                    tb[(i * (tlen + 1) + j) * d.n_states + t.out_id] =
                        (int16_t)(t.orig_idx + 1);
            }
            if (state_is_set[vc.end_id]) {
                int64_t tval = cell[vc.end_id * cell_sz];
                if (!end_is_set || best_score < tval) {
                    best_score = tval;
                    best_i = i;
                    best_j = j;
                    std::memcpy(best_cell.data(),
                                cell + vc.end_id * cell_sz,
                                sizeof(int64_t) * cell_sz);
                    end_is_set = true;
                }
            }
        }
        // rotate rows backwards
        int64_t* last = rows[mta];
        for (int64_t r = mta; r > 0; r--) rows[r] = rows[r - 1];
        rows[0] = last;
    }
    if (!end_is_set) return INT64_MIN;
    res[0] = best_score;
    res[3] = best_i;
    res[4] = best_j;
    res[1] = 0;
    res[2] = 0;
    if (want_extra) {
        res[1] = best_cell[1 + rs_q];
        res[2] = best_cell[1 + rs_t];
    }
    if (!want_path) return 0;
    // walk traceback (end -> start order; caller reverses)
    int64_t i = best_i, j = best_j, n_ops = 0;
    int16_t tid = tb[(i * (tlen + 1) + j) * d.n_states + vc.end_id];
    if (!tid) return INT64_MIN;
    // transitions indexed by orig idx == model order here
    while (true) {
        const TransDesc& t = trans[tid - 1];
        if (n_ops >= path_cap) return -(n_ops + 1);
        path_out[n_ops++] = tid - 1;
        i -= t.aq;
        j -= t.at;
        if (t.flags & F_FROM_START) break;
        tid = tb[(i * (tlen + 1) + j) * d.n_states + t.in_id];
        if (!tid) break;
    }
    res[1] = i;
    res[2] = j;
    return n_ops;
}

// Opaque result handle so Python can copy out variable-size arrays.
struct SdpResult {
    Outputs out;
    std::vector<TransDesc> trans;
    std::vector<SpanDesc> spans;
    PassDesc desc;
};

// All inputs arrive as structure-of-arrays (no cross-ABI struct
// marshaling): tmeta is int32 with stride 26 per transition, smeta is
// int64 with stride 7 per span, params is int64[25].
SdpResult* sdp_run_pass(
    const int64_t* params, const int32_t* tmeta,
    const int32_t* const* t_qvec, const int32_t* const* t_tvec,
    const int32_t* const* t_table, const int32_t* const* t_qidx,
    const int32_t* const* t_tidx, const int32_t* const* t_qover,
    const int64_t* smeta, const int32_t* starts_des,
    const int32_t* starts_onq, const int32_t* const* starts_vec,
    const int32_t* q_nt4, const int32_t* t_nt4, const int32_t* q_sym,
    const int32_t* t_sym, const int32_t* trans_idx, const int32_t* psub,
    const int64_t* blk_rows, const int64_t* blk_off,
    const int64_t* blk_q, const int64_t* seed_pt,
    const int64_t* seed_pq, const int64_t* seed_id,
    const int64_t* seed_score, int64_t* term_score, int64_t* term_q,
    int64_t* term_t, int64_t* term_tb) {
    SdpResult* res = new SdpResult();
    PassDesc& d = res->desc;
    d.n_states = (int32_t)params[0];
    d.n_shadow = (int32_t)params[1];
    d.n_trans = (int32_t)params[2];
    d.n_spans = (int32_t)params[3];
    d.is_forward = (int32_t)params[4];
    d.use_boundary = (int32_t)params[5];
    d.has_traceback = (int32_t)params[6];
    d.qlen = params[7];
    d.tlen = params[8];
    d.rqs = params[9];
    d.rts = params[10];
    d.dropoff = params[11];
    d.mta = params[12];
    d.n_blocked_rows = (int32_t)params[13];
    d.n_seeds = (int32_t)params[14];
    d.want_start_func = (int32_t)params[15];
    d.want_end_func = (int32_t)params[16];
    d.start_state_id = (int32_t)params[17];
    d.end_state_id = (int32_t)params[18];
    d.n_reg_seeds = (int32_t)params[19];
    d.q_nt4_len = params[20];
    d.t_nt4_len = params[21];
    d.q_sym_len = params[22];
    d.t_sym_len = params[23];
    d.psub_dim = (int32_t)params[24];
    res->trans.resize(d.n_trans);
    for (int32_t i = 0; i < d.n_trans; i++) {
        const int32_t* m = tmeta + (int64_t)i * 27;
        TransDesc& t = res->trans[i];
        t.aq = m[0];
        t.at = m[1];
        t.in_id = m[2];
        t.out_id = m[3];
        t.flags = m[4];
        t.gmode = m[5];
        t.gval = m[6];
        t.dim = m[7];
        t.shadow_kind = m[8];
        t.iw_use_q = m[9];
        t.iw_use_t = m[10];
        t.iw_lane_q = m[11];
        t.iw_lane_t = m[12];
        t.iw_min = m[13];
        t.iw_max = m[14];
        t.sc_phase = m[15];
        t.sc_q_is_dna = m[16];
        t.sc_t_is_dna = m[17];
        t.sc_on_q = m[18];
        t.sc_on_t = m[19];
        t.sc_lane_q = m[20];
        t.sc_lane_t = m[21];
        t.n_starts = m[22];
        t.starts_off = m[23];
        t.span_id = m[24];
        t.orig_idx = m[25];
        t.can_wrap = m[26];
        t.qvec = t_qvec[i];
        t.tvec = t_tvec[i];
        t.table = t_table[i];
        t.q_idx = t_qidx[i];
        t.t_idx = t_tidx[i];
        t.q_over = t_qover[i];
    }
    res->spans.resize(d.n_spans);
    for (int32_t i = 0; i < d.n_spans; i++) {
        const int64_t* m = smeta + (int64_t)i * 7;
        SpanDesc& sp = res->spans[i];
        sp.state_id = (int32_t)m[0];
        sp.min_q = m[1];
        sp.max_q = m[2];
        sp.min_t = m[3];
        sp.max_t = m[4];
        sp.qloop_orig = (int32_t)m[5];
        sp.tloop_orig = (int32_t)m[6];
    }
    d.trans = res->trans.data();
    d.spans = res->spans.data();
    d.starts_des = starts_des;
    d.starts_onq = starts_onq;
    d.starts_vec = starts_vec;
    d.q_nt4 = q_nt4;
    d.t_nt4 = t_nt4;
    d.q_sym = q_sym;
    d.t_sym = t_sym;
    d.trans_idx = trans_idx;
    d.psub = psub;
    d.blk_rows = blk_rows;
    d.blk_off = blk_off;
    d.blk_q = blk_q;
    d.seed_pt = seed_pt;
    d.seed_pq = seed_pq;
    d.seed_id = seed_id;
    d.seed_score = seed_score;
    res->out.term_score = term_score;
    res->out.term_q = term_q;
    res->out.term_t = term_t;
    res->out.term_tb = term_tb;
    Pass pass(d, res->out);
    pass.run();
    return res;
}

int64_t sdp_result_boundary_size(const SdpResult* r) {
    return (int64_t)r->out.boundary.size();
}

void sdp_result_boundary_copy(const SdpResult* r, int64_t* dst) {
    std::memcpy(dst, r->out.boundary.data(),
                r->out.boundary.size() * sizeof(int64_t));
}

int64_t sdp_result_tb_size(const SdpResult* r) {
    return (int64_t)r->out.tb_trans.size();
}

void sdp_result_tb_copy(const SdpResult* r, int32_t* trans,
                        int64_t* len, int64_t* prev) {
    std::memcpy(trans, r->out.tb_trans.data(),
                r->out.tb_trans.size() * sizeof(int32_t));
    std::memcpy(len, r->out.tb_len.data(),
                r->out.tb_len.size() * sizeof(int64_t));
    std::memcpy(prev, r->out.tb_prev.data(),
                r->out.tb_prev.size() * sizeof(int64_t));
}

void sdp_result_free(SdpResult* r) { delete r; }

}  // extern "C"
