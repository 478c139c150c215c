// telr_tpu_torch host kernel: the consensus of the pileup vote's insertion
// events, every event of a vote round in one call.
//
// An insertion event is the set of read sequences inserted at one backbone
// column (or pooled over a few neighbouring columns); most are one to three
// bases with tens of supporters.  Per event, in this order:
//   - a single supporter is the consensus;
//   - an exact majority (more than half the supporters carry the same
//     sequence) is the consensus;
//   - the representative is the median-length supporter (stable by length);
//     one over 400 bases (a whole-TE splice from a non-spanning backbone,
//     alignable on its own), or an empty one, is the consensus;
//   - otherwise every supporter is aligned GLOBAL to the representative
//     (the row-banded DP of kernels/dp.py with DPParams()' scores, the width
//     rule of _prep_pair and the band of make_band_offsets), the M columns
//     vote bases and the D columns deletions; a column keeps the first
//     maximum, the representative's base on a tie or with no vote, and is
//     dropped where deletions are a strict majority of its coverage; nested
//     insertions, left-shifted, are spliced in where more than half the
//     column's coverage carries one (more than half the supporters past the
//     end), taking the first whose length is nearest the median.
// The recurrence, its direction bytes and the traceback's tie order are
// those of the JAX package's host engine (banded_dp_one_t, dp_pass1,
// dp_pass2 and telr_traceback in native/telr_native.cpp), copied here in
// their portable form for the GLOBAL mode, so the port owns its copy.
// tests/test_torch_vote_events.py holds every consensus byte-equal to the
// JAX package's per-event Python rule.
//
// Exposed as a plain C ABI consumed via ctypes (telr_tpu_torch/io/native.py,
// built by telr_tpu_torch/io/host_lib.py); all buffers are caller-allocated
// numpy arrays, and the work buffers are reused across every pair and event.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace insev {

constexpr int32_t NEG = -(1 << 30);
constexpr int32_t NEGH = NEG / 2;
// kernels/dp.py DPParams(): match, mismatch, gap open, gap extend
constexpr int32_t MA = 2, MI = 4, GO = 4, GE = 2;
// longer representatives are kept as they are
constexpr int64_t CONSENSUS_MAX = 400;

// kernels/dp.py _bucket
static int64_t bucket(int64_t n) {
    static const int64_t quanta[] = {64, 128, 256, 512, 1024, 2048, 4096,
                                     8192, 16384, 32768, 65536};
    for (int64_t b : quanta)
        if (n <= b) return b;
    return ((n + 8191) / 8192) * 8192;
}

// kernels/dp.py _prep_pair's band width when none is given
static int32_t band_width(int64_t lq, int64_t lt) {
    int64_t d = lt > lq ? lt - lq : lq - lt;
    int64_t w = bucket(std::max({d + 65, (int64_t)128,
                                 std::min(std::max(lq, lt) + 2,
                                          (int64_t)256)}));
    return (int32_t)std::min(w, bucket(lt + 1));
}

struct Work {
    std::vector<int32_t> off;                 // band offsets, lq + 1
    std::vector<int64_t> o64;
    std::vector<int32_t> hp, ip, i_cur, dg, hrow, iext, hnodv, gbuf, mx,
        dbyte, tb;
    std::vector<uint8_t> dirs;                // lq x W direction bytes
    std::vector<uint8_t> ops;                 // traceback runs, reversed
    std::vector<int32_t> lens;
    std::vector<int32_t> votes, delv, cov;    // n x 5, n, n
    std::vector<int8_t> best;
    std::vector<int64_t> order;               // supporters by length
    // nested insertions, in order of arrival: column, start in
    // nest_codes, length
    struct Nest { int64_t col, start, len; };
    std::vector<Nest> nests;
    std::vector<int8_t> nest_codes;
    std::vector<int64_t> group_lens;
    int64_t dp_events = 0, pairs = 0, cells = 0;
};

// kernels/dp.py make_band_offsets
static void band_offsets(int64_t lq, int64_t lt, int64_t width, Work& w) {
    w.o64.resize(lq + 1);
    int64_t* o = w.o64.data();
    const int64_t hi = std::max<int64_t>(0, lt - width + 1);
    const double step = (double)lt / (double)lq;
    int64_t run = 0;
    for (int64_t i = 0; i <= lq; i++) {
        double center = (double)i * step;
        int64_t v = (int64_t)std::nearbyint(center) - width / 2;
        v = std::min(std::max(v, (int64_t)0), hi);
        run = (i == 0 || v > run) ? v : run;     // maximum.accumulate
        o[i] = run;
    }
    // limit the per-row shift to the width (path continuity)
    for (int pass = 0; pass < 2; pass++) {
        bool ok = true;
        for (int64_t i = 1; i <= lq && ok; i++) ok = o[i] - o[i - 1] <= width;
        if (ok) break;
        int64_t prev_old = o[0], acc = o[0];
        for (int64_t i = 1; i <= lq; i++) {
            int64_t d = std::min(o[i] - prev_old, width);
            prev_old = o[i];
            acc += d;
            o[i] = acc;
        }
        for (int64_t i = 0; i <= lq; i++)
            o[i] = std::min(std::max(o[i], (int64_t)0), hi);
    }
    w.off.resize(lq + 1);
    for (int64_t i = 0; i <= lq; i++) w.off[i] = (int32_t)o[i];
}

// The engine's banded_dp_one_t<GLOBAL> over one pair: fills w.dirs
// (row i - 1 = query position i, W cells from off[i]).  The score and best
// cell are not kept: a GLOBAL walk starts at (lq, lt).
static void banded_dp_global(const int8_t* q, int32_t lq, const int8_t* t,
                             int32_t lt, int32_t W, Work& w) {
    const int32_t* off = w.off.data();
    w.hp.assign(2 * W + 2, NEG);
    w.ip.assign(2 * W + 2, NEG);
    w.i_cur.resize(W);
    w.dg.resize(W);
    w.hrow.resize(W);
    w.iext.resize(W);
    w.hnodv.assign(W + 1, NEG);
    int32_t* hnod = w.hnodv.data() + 1;
    w.gbuf.resize(W);
    w.mx.resize(W);
    w.dbyte.resize(W);
    w.tb.assign((int64_t)lt + W + 2, 5);
    for (int32_t x = 0; x < lt; x++) w.tb[x + 1] = t[x];
    w.dirs.resize((size_t)lq * W);
    int32_t* hp = w.hp.data();
    int32_t* ip = w.ip.data();
    int32_t* i_cur = w.i_cur.data();
    int32_t* dg = w.dg.data();
    int32_t* hrow = w.hrow.data();
    int32_t* iext = w.iext.data();
    int32_t* gbuf = w.gbuf.data();
    int32_t* mx = w.mx.data();
    int32_t* dbyte = w.dbyte.data();

    for (int32_t p = 0; p < W; p++) {
        int64_t j0 = (int64_t)off[0] + p;
        int32_t v = (j0 == 0) ? 0 : (int32_t)(-(GO + (int64_t)GE * j0));
        hp[p + 1] = (j0 <= lt) ? v : NEG;
    }
    for (int32_t i = 1; i <= lq; i++) {
        const int32_t qi = q[i - 1];
        const int32_t off_i = off[i];
        const int32_t d_i = off[i] - off[i - 1];
        uint8_t* drow = w.dirs.data() + (int64_t)(i - 1) * W;
        const int32_t* hprev = hp + d_i;
        const int32_t* iprev = ip + d_i;
        const int32_t* trow = w.tb.data() + off_i;
        const int32_t p_lo = off_i >= 1 ? 0 : 1 - off_i;
        const int64_t ph = (int64_t)lt - off_i;
        const int32_t p_hi = ph >= W ? W - 1 : (ph < -1 ? -1 : (int32_t)ph);

        // vertical gap, diagonal (dp_pass1)
        const int32_t q_amb = (qi == 4) ? -1 : 0;
        for (int32_t p = 0; p < W; p++) {
            int32_t h_up = hprev[p + 1];
            int32_t i_open = (h_up > NEGH) ? h_up - GO - GE : NEG;
            int32_t i_up = iprev[p + 1];
            int32_t i_ext = (i_up > NEGH) ? i_up - GE : NEG;
            int32_t ic = i_open > i_ext ? i_open : i_ext;
            i_cur[p] = ic;
            int32_t ine = (ic == i_open) ? 0 : 1;
            int32_t igt = (ic > NEGH) ? 1 : 0;
            iext[p] = ine & igt;
            int32_t tc = trow[p];
            int32_t s = (tc == qi) ? MA : -MI;
            s = (q_amb | (tc >= 4)) ? -1 : s;        // DPParams().ambig
            int32_t h_diag = hprev[p];
            int32_t d = (h_diag > NEGH) ? h_diag + s : NEG;
            dg[p] = d;
            hnod[p] = d > ic ? d : ic;
        }
        for (int32_t p = 0; p < p_lo && p < W; p++) hnod[p] = NEG;
        for (int32_t p = p_hi + 1; p < W; p++) if (p >= 0) hnod[p] = NEG;
        if (off_i == 0) hnod[0] = i_cur[0];

        // horizontal gap: the prefix max, then the choices (dp_pass2)
        for (int32_t p = 0; p < W; p++) {
            int32_t hn = hnod[p];
            gbuf[p] = (hn > NEGH) ? hn + GE * p - GO - GE : NEG;
        }
        {
            int32_t m_run = NEG;
            for (int32_t p = 0; p < W; p++) {
                mx[p] = m_run;
                m_run = m_run > gbuf[p] ? m_run : gbuf[p];
            }
        }
        for (int32_t p = 0; p < W; p++) {
            int32_t m_ex = mx[p];
            int32_t dc = (m_ex > NEGH) ? m_ex - GE * (p - 1) : NEG;
            bool in_t = (p >= p_lo) & (p <= p_hi);
            dc = in_t ? dc : NEG;
            int32_t prev_hnod = hnod[p - 1];
            int32_t open_cand = (prev_hnod > NEGH + GO + GE)
                                    ? prev_hnod - GO - GE : NEG;
            int32_t dne = (dc == open_cand) ? 0 : 1;
            int32_t dgt = (dc > NEGH) ? 1 : 0;
            int32_t dext = dne & dgt;
            int32_t hn = hnod[p];
            int32_t hc = hn > dc ? hn : dc;
            int32_t choice = (hc == dg[p]) ? 0 : ((hc == dc) ? 1 : 2);
            dbyte[p] = choice | (dext << 2) | (iext[p] << 3);
            hrow[p] = hc;
        }
        if (off_i == 0) {
            // the j == 0 cell: vertical only, choice I, no D
            dbyte[0] = 2 | (iext[0] << 3);
            hrow[0] = hnod[0];
        }
        for (int32_t p = 0; p < W; p++) drow[p] = (uint8_t)dbyte[p];
        memcpy(hp + 1, hrow, (size_t)W * sizeof(int32_t));
        memcpy(ip + 1, i_cur, (size_t)W * sizeof(int32_t));
    }
}

// The engine's telr_traceback from (lq, lt) in GLOBAL mode: the runs
// (0 = M, 1 = D, 2 = I) in reverse into w.ops / w.lens.  False where the
// walk leaves the band.
static bool traceback_global(int32_t lq, int32_t lt, int32_t W, Work& w) {
    const int32_t* off = w.off.data();
    w.ops.clear();
    w.lens.clear();
    auto push = [&](uint8_t op) {
        if (!w.ops.empty() && w.ops.back() == op) { w.lens.back()++; return; }
        w.ops.push_back(op);
        w.lens.push_back(1);
    };
    int32_t i = lq, j = lt, state = 0;   // 0 = H, 1 = D, 2 = I
    while (i > 0 || j > 0) {
        if (i == 0) { push(1); j--; continue; }
        int32_t p = j - off[i];
        if (p < 0 || p >= W) return false;
        uint8_t byte = w.dirs[(int64_t)(i - 1) * W + p];
        uint8_t choice = byte & 3;
        if (state == 0) {
            if (j == 0 || choice == 2) { state = 2; continue; }
            if (choice == 0) { push(0); i--; j--; continue; }
            if (choice == 1) { state = 1; continue; }
            return false;
        } else if (state == 1) {
            push(1);
            j--;
            if (!(byte & 4)) state = 0;
        } else {
            push(2);
            i--;
            if (!(byte & 8)) state = 0;
        }
    }
    return true;
}

static inline bool same(const int8_t* a, int64_t la, const int8_t* b,
                        int64_t lb) {
    return la == lb && (la == 0 || memcmp(a, b, (size_t)la) == 0);
}

// One event's consensus into out; returns its length, -1 for a walk that
// left the band, -3 for a base code outside 0..4.
static int64_t event_consensus(const int8_t* codes, const int64_t* sup_off,
                               const int64_t* sup, int64_t n, int8_t* out,
                               Work& w) {
    auto seq = [&](int64_t k) { return codes + sup_off[sup[k]]; };
    auto len = [&](int64_t k) {
        return sup_off[sup[k] + 1] - sup_off[sup[k]];
    };
    auto emit = [&](int64_t k) {
        memcpy(out, seq(k), (size_t)len(k));
        return len(k);
    };
    if (n == 1) return emit(0);
    // a strict majority is the one Boyer-Moore candidate that counts over
    // half the supporters
    int64_t cand = 0, votes = 0;
    for (int64_t k = 0; k < n; k++) {
        if (votes == 0) { cand = k; votes = 1; }
        else if (same(seq(k), len(k), seq(cand), len(cand))) votes++;
        else votes--;
    }
    int64_t cnt = 0;
    for (int64_t k = 0; k < n; k++)
        cnt += same(seq(k), len(k), seq(cand), len(cand));
    if (2 * cnt > n) return emit(cand);

    w.order.resize(n);
    for (int64_t k = 0; k < n; k++) w.order[k] = k;
    std::stable_sort(w.order.begin(), w.order.end(),
                     [&](int64_t a, int64_t b) { return len(a) < len(b); });
    const int64_t r = w.order[n / 2];
    const int64_t lt = len(r);
    if (lt > CONSENSUS_MAX || lt == 0) return emit(r);
    const int8_t* rep = seq(r);

    w.dp_events++;
    w.pairs += n;
    w.votes.assign(lt * 5, 0);
    w.delv.assign(lt, 0);
    w.cov.assign(lt, 0);
    w.nests.clear();
    w.nest_codes.clear();
    for (int64_t k = 0; k < n; k++) {
        const int8_t* s = seq(k);
        const int64_t lq = len(k);
        w.cells += lq * lt;
        if (lq == 0) continue;            // _prep_pair: an empty cigar
        const int32_t W = band_width(lq, lt);
        band_offsets(lq, lt, W, w);
        banded_dp_global(s, (int32_t)lq, rep, (int32_t)lt, W, w);
        if (!traceback_global((int32_t)lq, (int32_t)lt, W, w)) return -1;
        int64_t qi = 0, tj = 0;
        for (int64_t x = (int64_t)w.ops.size() - 1; x >= 0; x--) {
            const int64_t ln = w.lens[x];
            if (w.ops[x] == 0) {
                for (int64_t y = 0; y < ln; y++) {
                    int8_t b = s[qi + y];
                    if (b < 0 || b > 4) return -3;
                    w.votes[(tj + y) * 5 + b]++;
                    w.cov[tj + y]++;
                }
                qi += ln;
                tj += ln;
            } else if (w.ops[x] == 1) {
                for (int64_t y = 0; y < ln; y++) {
                    w.delv[tj + y]++;
                    w.cov[tj + y]++;
                }
                tj += ln;
            } else {
                // device_vote.leftshift_ins: rotate right while the base
                // before the column equals the sequence's last base
                const int64_t start = (int64_t)w.nest_codes.size();
                w.nest_codes.insert(w.nest_codes.end(), s + qi, s + qi + ln);
                int8_t* sq = w.nest_codes.data() + start;
                int64_t js = tj;
                while (js > 0 && rep[js - 1] == sq[ln - 1]) {
                    std::rotate(sq, sq + ln - 1, sq + ln);
                    js--;
                }
                w.nests.push_back({js, start, ln});
                qi += ln;
            }
        }
    }
    // each column: the first maximum, the representative's base on a tie
    // with it or where no base voted
    w.best.resize(lt);
    for (int64_t j = 0; j < lt; j++) {
        const int32_t* v = w.votes.data() + j * 5;
        int32_t b = 0, sum = v[0];
        for (int32_t c = 1; c < 5; c++) {
            sum += v[c];
            if (v[c] > v[b]) b = c;
        }
        const int8_t bb = rep[j];
        if (bb < 0 || bb > 4) return -3;
        if (v[b] == v[bb] || sum == 0) b = bb;
        w.best[j] = (int8_t)b;
    }
    // nested insertions by column, each column's in order of arrival
    std::stable_sort(w.nests.begin(), w.nests.end(),
                     [](const Work::Nest& a, const Work::Nest& b) {
                         return a.col < b.col;
                     });
    int64_t o = 0, prev = 0;
    auto kept = [&](int64_t a, int64_t b) {
        for (int64_t j = a; j < b; j++)
            if (!(w.delv[j] * 2 > w.cov[j])) out[o++] = w.best[j];
    };
    for (size_t g0 = 0; g0 < w.nests.size();) {
        size_t g1 = g0;
        const int64_t j = w.nests[g0].col;
        while (g1 < w.nests.size() && w.nests[g1].col == j) g1++;
        const int64_t m = (int64_t)(g1 - g0);
        const int64_t need = j < lt ? w.cov[j] : n;
        if (2 * m > need) {
            w.group_lens.clear();
            for (size_t x = g0; x < g1; x++)
                w.group_lens.push_back(w.nests[x].len);
            std::sort(w.group_lens.begin(), w.group_lens.end());
            const int64_t med = w.group_lens[m / 2];
            size_t pick = g0;
            int64_t dist = -1;
            for (size_t x = g0; x < g1; x++) {
                int64_t d = std::llabs(w.nests[x].len - med);
                if (dist < 0 || d < dist) { dist = d; pick = x; }
            }
            kept(prev, j);
            memcpy(out + o, w.nest_codes.data() + w.nests[pick].start,
                   (size_t)w.nests[pick].len);
            o += w.nests[pick].len;
            prev = j;
        }
        g0 = g1;
    }
    kept(prev, lt);
    return o;
}

}  // namespace insev

extern "C" {

// The consensus of n_events insertion events.  Supporter s is
// codes[sup_off[s] .. sup_off[s + 1]); event e's supporters are
// ev_sup[ev_off[e] .. ev_off[e + 1]), in the order the vote met them.
// Event e's consensus is written to out[out_off[e] .. out_off[e + 1]); an
// event needs at most its representative's length plus the sum of its
// supporters' lengths of out.  Returns the total written, or -1 where a
// traceback left the band, -2 where out_cap is too small, -3 for a base
// code outside 0..4.  stats[0..2] <- the events that ran the DP, their
// supporters (pairs) and the sum of len(supporter) x len(representative).
int64_t telr_ins_event_consensus_batch(const int8_t* codes,
                                       const int64_t* sup_off,
                                       const int64_t* ev_sup,
                                       const int64_t* ev_off,
                                       int64_t n_events, int8_t* out,
                                       int64_t out_cap, int64_t* out_off,
                                       int64_t* stats) {
    insev::Work w;
    int64_t o = 0;
    out_off[0] = 0;
    for (int64_t e = 0; e < n_events; e++) {
        const int64_t* sup = ev_sup + ev_off[e];
        const int64_t n = ev_off[e + 1] - ev_off[e];
        int64_t need = 0, longest = 0;
        for (int64_t k = 0; k < n; k++) {
            int64_t l = sup_off[sup[k] + 1] - sup_off[sup[k]];
            need += l;
            longest = std::max(longest, l);
        }
        if (o + need + longest > out_cap) return -2;
        int64_t m = n ? insev::event_consensus(codes, sup_off, sup, n,
                                               out + o, w)
                      : 0;
        if (m < 0) return m;
        o += m;
        out_off[e + 1] = o;
    }
    stats[0] = w.dp_events;
    stats[1] = w.pairs;
    stats[2] = w.cells;
    return o;
}

}  // extern "C"
