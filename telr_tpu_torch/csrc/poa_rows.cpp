// telr_tpu_torch host POA: banded partial-order consensus (the wtpoa-cns
// role, reference TELR_assembly.py:225-247) with the DP in row form.
//
// The graph, the banding rule, the scoring, the traceback, the weave and the
// consensus path are those of the JAX package's engine (telr_poa_consensus
// in native/telr_native.cpp), carried here so that the port owns its copy;
// only how each read's banded DP is computed differs, and the consensus is
// the same bytes (tests/test_torch_poa.py holds the two equal).
//
// Exposed as a plain C ABI consumed via ctypes (telr_tpu_torch/io/native.py,
// built by telr_tpu_torch/io/host_lib.py); all buffers are caller-allocated
// numpy arrays.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace poa {

// abPOA-style banding: every node carries an approximate backbone column;
// a read (fit-aligned: read global, graph free at both ends) only visits
// nodes whose column is within W of its expected position.  Topological
// order is a doubly-linked list; new nodes insert right after their
// alignment predecessor, which preserves order validity.

struct Edge { int32_t to; int32_t w; };

struct Graph {
    std::vector<int8_t> base;
    std::vector<int32_t> col;       // approximate backbone column (band key)
    std::vector<int32_t> nweight;   // read-path visits
    std::vector<std::vector<Edge>> preds;   // incoming edges
    std::vector<int32_t> nxt, prv;  // topo order linked list
    int32_t head = -1, tail = -1;

    int32_t add_node(int8_t b, int32_t c) {
        base.push_back(b);
        col.push_back(c);
        nweight.push_back(0);
        preds.push_back({});
        nxt.push_back(-1);
        prv.push_back(-1);
        return (int32_t)base.size() - 1;
    }
    void insert_after(int32_t v, int32_t after) {
        if (after < 0) {  // new head
            nxt[v] = head; prv[v] = -1;
            if (head >= 0) prv[head] = v;
            head = v;
            if (tail < 0) tail = v;
            return;
        }
        nxt[v] = nxt[after]; prv[v] = after;
        if (nxt[after] >= 0) prv[nxt[after]] = v;
        nxt[after] = v;
        if (after == tail) tail = v;
    }
    void bump_edge(int32_t u, int32_t v) {
        for (auto& e : preds[v])
            if (e.to == u) { e.w++; return; }
        preds[v].push_back({u, 1});
    }
};

static const int32_t NEG = -(1 << 28);

// ---------------------------------------------------------------------------
// Fit-align one read segment to the graph and weave it in: the DP of the
// engine's poa_add_read (native/telr_native.cpp), its directions, traceback
// and weave, computed over only the read's active nodes.  One walk of the
// topological list ranks them and fixes each one's band start; a node's band
// row is then updated one predecessor at a time over the j range the two
// bands share, in branch-free loops over contiguous int32 rows that the
// compiler vectorises.  Rows hold L = min(band, m + 1) cells: every band
// start lies in [0, m + 1 - band] when m + 1 >= band, and is 0 otherwise.
// The direction bytes are kept for every row, for the traceback; the H and D
// rows only as long as a successor may read them, in a ring as deep as the
// farthest predecessor in rank, so the rows a node reads are still in cache.
// The buffers belong to a RowWork that serves every read of one call.
//
// Equal to poa_add_read cell for cell, whose buffers are NEG-filled per read:
// a predecessor ranked after its successor (merged ALT nodes make such
// edges) is not computed yet and reads as an all-NEG row, never skipped
// (NEG + match beats an untouched NEG in the diagonal); an inactive
// predecessor is skipped, as there.  Candidates come in preds order with the
// same strict and non-strict comparisons, and the predecessor index is the
// same wrapping uint8_t.  col0 = backbone column where the read segment
// starts.  alt_at maps (backbone column, base) -> existing mismatch-ALT
// node; ins_after maps (pred node, base) -> existing insertion node (POA
// merging).
// ---------------------------------------------------------------------------

struct Step { int32_t node; int64_t j; };   // node id, or -1 for insertion

struct RowWork {
    std::vector<int32_t> rank;          // node id -> active row, or -1
    std::vector<int32_t> node;          // active row -> node id
    std::vector<int64_t> lo;            // active row -> band start
    std::vector<int32_t> hm;            // active row -> H at j = m
    std::vector<int32_t> H, D;          // ring of rows x L scores
    // rows x L: dir = dH | (dD == 2) << 2 | (dI == 2) << 3; pH, pD = the
    // predecessor index of the diagonal and of D
    std::vector<uint8_t> dir, pH, pD;
    // one row each: tag = predecessor index << 2 | direction, for H and D;
    // an all-NEG row for predecessors not computed yet
    std::vector<int32_t> tH, tD, neg;
    std::vector<Step> path;
    int64_t rows = 0, cells = 0, late_rows = 0;
};

// D from one predecessor over n shared cells: open from its H, extend its D
static inline void row_del(int32_t* __restrict Dv, int32_t* __restrict tD,
                           const int32_t* __restrict Hu,
                           const int32_t* __restrict Du, int32_t n,
                           int32_t gog, int32_t ge, int32_t tag) {
    for (int32_t k = 0; k < n; k++) {
        int32_t b = Dv[k], t = tD[k];
        int32_t o = Hu[k] - gog, e = Du[k] - ge;
        bool c1 = o > b;
        b = c1 ? o : b;
        t = c1 ? (tag | 1) : t;
        bool c2 = e > b;
        b = c2 ? e : b;
        t = c2 ? (tag | 2) : t;
        Dv[k] = b;
        tD[k] = t;
    }
}

// the diagonal from one predecessor over n cells; rd[k] is the read base
// the cell consumes
static inline void row_diag(int32_t* __restrict Hv, int32_t* __restrict tH,
                            const int32_t* __restrict Hu,
                            const int8_t* __restrict rd, int32_t n,
                            int32_t bv, int32_t ma, int32_t mi, int32_t tag) {
    for (int32_t k = 0; k < n; k++) {
        int32_t rb = rd[k];
        int32_t sc = (rb == bv && rb < 4) ? ma
                     : (rb >= 4 || bv >= 4) ? -1 : -mi;
        int32_t cand = Hu[k] + sc;
        bool c = cand > Hv[k];
        Hv[k] = c ? cand : Hv[k];
        tH[k] = c ? (tag | 1) : tH[k];
    }
}

typedef int32_t i32x8 __attribute__((vector_size(32)));
typedef uint8_t u8x8 __attribute__((vector_size(8)));

static inline i32x8 splat8(int32_t x) { return (i32x8){} + x; }
static inline i32x8 vmax8(i32x8 a, i32x8 b) { return a > b ? a : b; }
// lanes moved up by 1, 2 or 4, the freed low lanes taken from f
static inline i32x8 up1(i32x8 x, i32x8 f) {
    return __builtin_shuffle(x, f, (i32x8){8, 0, 1, 2, 3, 4, 5, 6});
}
static inline i32x8 up2(i32x8 x, i32x8 f) {
    return __builtin_shuffle(x, f, (i32x8){8, 9, 0, 1, 2, 3, 4, 5});
}
static inline i32x8 up4(i32x8 x, i32x8 f) {
    return __builtin_shuffle(x, f, (i32x8){8, 9, 10, 11, 0, 1, 2, 3});
}

// I, then H from I, then the row's direction bytes.  I consumes read base
// j-1 within the row (k >= 1).  Step by step I[k] = max(H[k-1] - go - ge,
// I[k-1] - ge), open winning ties, where H[k-1] has already taken I[k-1] if
// strictly greater; with go >= 0 that raise never beats the extension, so
// I[k] + k*ge is the running max of NEG and Hpre[i] - go + i*ge over i < k,
// Hpre being H before I: a prefix max, eight cells at a time.  dI is 2
// where the extension beat the open from the final H[k-1].
static inline void row_ins(int32_t* __restrict Hv,
                           const int32_t* __restrict tH,
                           const int32_t* __restrict tD,
                           uint8_t* __restrict dir, uint8_t* __restrict pH,
                           uint8_t* __restrict pD, int32_t L, int32_t go,
                           int32_t ge) {
    const int32_t gog = go + ge;
    const i32x8 iota = {0, 1, 2, 3, 4, 5, 6, 7}, negv = splat8(NEG);
    // running values: Hpre[k-1], H[k-1], I[k-1] and the prefix max
    int32_t hpre = Hv[0], hfin = Hv[0], ilast = NEG, M = NEG;
    dir[0] = (uint8_t)((tH[0] & 3) | ((tD[0] & 3) == 2) << 2);
    pH[0] = (uint8_t)(tH[0] >> 2);
    pD[0] = (uint8_t)(tD[0] >> 2);
    int32_t k = 1;
    for (; k + 8 <= L; k += 8) {
        i32x8 y, th, td;
        std::memcpy(&y, Hv + k, sizeof y);
        std::memcpy(&th, tH + k, sizeof th);
        std::memcpy(&td, tD + k, sizeof td);
        i32x8 x = up1(y, splat8(hpre)) + (iota + (k - 1)) * ge - go;
        x = vmax8(x, up1(x, negv));
        x = vmax8(x, up2(x, negv));
        x = vmax8(x, up4(x, negv));
        x = vmax8(x, splat8(M));
        i32x8 I = x - (iota + k) * ge;
        i32x8 c = I > y;
        i32x8 H = c ? I : y;
        th = c ? (th | 3) : th;
        i32x8 ext = (up1(H, splat8(hfin)) - gog) < (up1(I, splat8(ilast)) - ge);
        i32x8 d = (th & 3) | (((td & 3) == 2) & 4) | (ext & 8);
        std::memcpy(Hv + k, &H, sizeof H);
        u8x8 db = __builtin_convertvector(d, u8x8),
             hb = __builtin_convertvector(th >> 2, u8x8),
             tb = __builtin_convertvector(td >> 2, u8x8);
        std::memcpy(dir + k, &db, 8);
        std::memcpy(pH + k, &hb, 8);
        std::memcpy(pD + k, &tb, 8);
        hpre = y[7]; hfin = H[7]; ilast = I[7]; M = x[7];
    }
    for (; k < L; k++) {
        int32_t y = Hv[k];
        int32_t x = hpre + (k - 1) * ge - go;
        M = x > M ? x : M;
        int32_t I = M - k * ge;
        bool c = I > y;
        int32_t H = c ? I : y;
        int32_t th = c ? (tH[k] | 3) : tH[k];
        int32_t ext = (hfin - gog) < (ilast - ge);
        dir[k] = (uint8_t)((th & 3) | ((tD[k] & 3) == 2) << 2 | ext << 3);
        pH[k] = (uint8_t)(th >> 2);
        pD[k] = (uint8_t)(tD[k] >> 2);
        Hv[k] = H;
        hpre = y; hfin = H; ilast = I;
    }
}

// weave a traced path into the graph, in forward order
static void poa_weave(Graph& g, const int8_t* read, int64_t col0,
                      const std::vector<Step>& path,
                      std::unordered_map<int64_t, int32_t>& alt_at,
                      std::unordered_map<int64_t, int32_t>& ins_after) {
    int32_t prev_node = -1;
    for (auto it = path.rbegin(); it != path.rend(); ++it) {
        int8_t rb = read[it->j - 1];
        int32_t cur = -1;
        if (it->node >= 0 && g.base[it->node] == rb) {
            cur = it->node;                       // match
        } else if (it->node >= 0) {
            // mismatch: merge with an existing ALT node at this column
            int64_t key = ((int64_t)g.col[it->node] << 3) | rb;
            auto f = alt_at.find(key);
            if (f != alt_at.end()) cur = f->second;
            else {
                cur = g.add_node(rb, g.col[it->node]);
                g.insert_after(cur, g.prv[it->node] >= 0
                                        ? g.prv[it->node] : -1);
                alt_at.emplace(key, cur);
            }
        } else {
            // insertion: merge with an existing ins node after prev
            int64_t key = ((int64_t)(prev_node + 1) << 3) | rb | (1LL << 62);
            auto f = ins_after.find(key);
            if (f != ins_after.end()) cur = f->second;
            else {
                int32_t c = prev_node >= 0 ? g.col[prev_node]
                                           : (int32_t)col0;
                cur = g.add_node(rb, c);
                g.insert_after(cur, prev_node >= 0 ? prev_node : -1);
                ins_after.emplace(key, cur);
            }
        }
        g.nweight[cur] += 1;
        if (prev_node >= 0 && prev_node != cur) g.bump_edge(prev_node, cur);
        prev_node = cur;
    }
}

static void poa_add_read_rows(Graph& g, const int8_t* read, int64_t m,
                              int64_t col0, int64_t col1, int32_t W,
                              int32_t ma, int32_t mi,
                              int32_t go, int32_t ge,
                              std::unordered_map<int64_t, int32_t>& alt_at,
                              std::unordered_map<int64_t, int32_t>& ins_after,
                              RowWork& w) {
    const int32_t band = 2 * W + 1;
    const int32_t n = (int32_t)g.base.size();
    const int32_t L = (int32_t)std::min<int64_t>(band, m + 1);
    const double scale = col1 > col0 ? (double)m / (double)(col1 - col0)
                                     : 1.0;
    // ranking: the active nodes in topological order, each with
    // poa_add_read's band start
    w.rank.resize((size_t)n, -1);
    w.node.clear();
    w.lo.clear();
    for (int32_t v = g.head; v >= 0; v = g.nxt[v]) {
        if (!(g.col[v] >= col0 - W - 1 && g.col[v] <= col1 + W + 1))
            continue;
        int64_t ctr = (int64_t)((g.col[v] - col0) * scale + 0.5);
        int64_t lo = ctr - W;
        if (lo > (int64_t)m + 1 - band) lo = (int64_t)m + 1 - band;
        if (lo < 0) lo = 0;
        w.rank[v] = (int32_t)w.node.size();
        w.node.push_back(v);
        w.lo.push_back(lo);
    }
    const int32_t R = (int32_t)w.node.size();
    const size_t cells = (size_t)R * L;
    // ring depth: one more than the farthest earlier predecessor
    int32_t depth = 1;
    for (int32_t r = 0; r < R; r++)
        for (auto& e : g.preds[w.node[r]]) {
            const int32_t ru = w.rank[e.to];
            if (ru >= 0 && ru < r) depth = std::max(depth, r - ru + 1);
        }
    if (w.H.size() < (size_t)depth * L) {
        w.H.resize((size_t)depth * L); w.D.resize((size_t)depth * L);
    }
    if (w.dir.size() < cells) {
        w.dir.resize(cells); w.pH.resize(cells); w.pD.resize(cells);
    }
    w.hm.resize(R);
    if (w.neg.size() < (size_t)L) {
        w.tH.resize(L); w.tD.resize(L);
        w.neg.assign(L, NEG);
    }
    int32_t* tH = w.tH.data();
    int32_t* tD = w.tD.data();
    const int32_t gog = go + ge;

    for (int32_t r = 0; r < R; r++) {
        const int32_t v = w.node[r];
        const int64_t lo = w.lo[r];
        int32_t* Hv = w.H.data() + (size_t)(r % depth) * L;
        int32_t* Dv = w.D.data() + (size_t)(r % depth) * L;
        // a predecessor's H or D row: all NEG while not computed yet
        auto row_of = [&](const std::vector<int32_t>& a, int32_t ru) {
            return ru > r ? w.neg.data()
                          : a.data() + (size_t)(ru % depth) * L;
        };
        for (int32_t k = 0; k < L; k++) {
            Dv[k] = NEG; tD[k] = 1;
        }
        // D: skip node v (no read base), from each predecessor's cell at j
        bool late = false;
        int32_t pi = 0;
        for (auto& e : g.preds[v]) {
            const int32_t ru = w.rank[e.to];
            const int32_t tag = (pi++ & 255) << 2;
            if (ru < 0) continue;
            late |= ru > r;
            const int64_t lu = w.lo[ru];
            const int32_t* Hu = row_of(w.H, ru);
            const int32_t* Du = row_of(w.D, ru);
            const int64_t a = std::max(lo, lu), b = std::min(lo, lu) + L;
            if (a < b)
                row_del(Dv + (a - lo), tD + (a - lo), Hu + (a - lu),
                        Du + (a - lu), (int32_t)(b - a), gog, ge, tag);
        }
        w.late_rows += late;
        // H: D where greater than the start (0 at j == 0, else NEG)
        for (int32_t k = 0; k < L; k++) {
            bool c = Dv[k] > NEG;
            Hv[k] = c ? Dv[k] : NEG;
            tH[k] = c ? 2 : 0;
        }
        if (lo == 0) {
            bool c = Dv[0] > 0;
            Hv[0] = c ? Dv[0] : 0;
            tH[0] = c ? 2 : 0;
        }
        // diag: consume read base j-1 at node v, from each predecessor's
        // cell at j-1; j >= lu + 1 >= 1
        const int32_t bv = g.base[v];
        pi = 0;
        for (auto& e : g.preds[v]) {
            const int32_t ru = w.rank[e.to];
            const int32_t tag = (pi++ & 255) << 2;
            if (ru < 0) continue;
            const int64_t lu = w.lo[ru];
            const int32_t* Hu = row_of(w.H, ru);
            const int64_t a = std::max(lo, lu + 1),
                          b = std::min(lo, lu + 1) + L;
            if (a < b)
                row_diag(Hv + (a - lo), tH + (a - lo), Hu + (a - 1 - lu),
                         read + (a - 1), (int32_t)(b - a), bv, ma, mi, tag);
        }
        row_ins(Hv, tH, tD, w.dir.data() + (size_t)r * L,
                w.pH.data() + (size_t)r * L, w.pD.data() + (size_t)r * L,
                L, go, ge);
        w.hm[r] = m < lo + L ? Hv[m - lo] : NEG;
    }
    w.rows += R;
    w.cells += (int64_t)cells;

    auto idx = [&](int32_t v, int64_t j) -> size_t {
        int32_t r = w.rank[v];
        return (size_t)r * L + (size_t)(j - w.lo[r]);
    };
    // best end: H[v][m] over active nodes whose band contains m, id order
    int32_t bv = -1; int32_t bs = NEG;
    for (int32_t v = 0; v < n; v++) {
        int32_t r = w.rank[v];
        if (r >= 0 && m >= w.lo[r] && m < w.lo[r] + L && w.hm[r] > bs) {
            bs = w.hm[r];
            bv = v;
        }
    }
    // traceback -> per-read-base steps
    w.path.clear();
    if (bv >= 0 && bs > 0) {
        int32_t v = bv; int64_t j = m; int state = 0;  // 0=H 1=D 2=I
        while (j > 0 || state != 0) {
            size_t iv = idx(v, j);
            uint8_t d = w.dir[iv];
            if (state == 0) {
                if ((d & 3) == 0) break;              // free start
                if ((d & 3) == 1) {
                    w.path.push_back({v, j});
                    v = g.preds[v][w.pH[iv]].to;
                    j -= 1;
                } else if ((d & 3) == 2) state = 1;
                else state = 2;
            } else if (state == 1) {
                int32_t u = g.preds[v][w.pD[iv]].to;
                if (!(d & 4)) state = 0;
                v = u;
            } else {
                w.path.push_back({-1, j});
                j -= 1;
                if (!(d & 8)) state = 0;
            }
        }
    }
    for (int32_t r = 0; r < R; r++) w.rank[w.node[r]] = -1;
    if (bv < 0 || bs <= 0) return;  // read could not be fit — skip it
    poa_weave(g, read, col0, w.path, alt_at, ins_after);
}

// consensus: heaviest path under MAJORITY-RELATIVE edge scoring, then trim
// tips whose node weight < min_cov.  A raw edge-weight sum lets a k-node
// insertion detour (w reads, k+1 edges) outscore the direct edge once
// (k+1)*w exceeds it — sub-majority read noise then bloats the consensus
// (measured: 109 inserted bases / 6kb at 15x ONT).  Scoring each edge as
// 2*w - local_coverage makes an edge profitable only with majority
// support, so detours must OUT-VOTE the direct edge per transition.
static int64_t poa_consensus_path(Graph& g, int32_t bb_len,
                                  int32_t min_cov,
                                  int8_t* out, int64_t cap) {
    int32_t n = (int32_t)g.base.size();
    std::vector<int64_t> score(n, 0);
    std::vector<int32_t> from(n, -1);
    int32_t best = -1; int64_t bs = -1;
    for (int32_t v = g.head; v >= 0; v = g.nxt[v]) {
        for (auto& e : g.preds[v]) {
            int32_t u = e.to;
            int32_t cov = g.nweight[u] > g.nweight[v] ? g.nweight[u]
                                                      : g.nweight[v];
            int64_t cand = score[u] + 2 * (int64_t)e.w - cov;
            // ties (ubiquitous where local coverage is 1-2: every
            // single-read variant scores 2w-cov = 0, same as the
            // incumbent) resolve toward the BACKBONE chain — the
            // incumbent consensus already carries the pileup vote's
            // all-reads evidence — then toward the heavier node
            bool take = false;
            if (cand > score[v]) take = true;
            else if (cand == score[v]) {
                if (from[v] < 0) take = true;   // extend beats fresh start
                else {
                    bool u_bb = (u == v - 1 && v < bb_len);
                    bool f_bb = (from[v] == v - 1 && v < bb_len);
                    if (u_bb && !f_bb) take = true;
                    else if (u_bb == f_bb
                             && g.nweight[u] > g.nweight[from[v]])
                        take = true;
                }
            }
            if (take) { score[v] = cand; from[v] = u; }
        }
        if (score[v] > bs) { bs = score[v]; best = v; }
    }
    std::vector<int32_t> path;
    // iteration cap: merged alt nodes can in pathological cases create a
    // backward edge (see poa_add_read_rows) — never walk longer than n
    for (int32_t v = best; v >= 0 && (int64_t)path.size() <= n;
         v = from[v])
        path.push_back(v);
    // forward order
    int64_t lo = 0, hi = (int64_t)path.size();
    // trim tips below min_cov
    while (hi > lo && g.nweight[path[(size_t)(hi - 1)]] < min_cov) hi--;
    while (lo < hi && g.nweight[path[(size_t)lo]] < min_cov) lo++;
    int64_t k = 0;
    for (int64_t i = hi - 1; i >= lo && k < cap; i--)
        out[k++] = g.base[path[(size_t)i]];
    return k;
}

}  // namespace poa

extern "C" {

// Banded partial-order consensus of read segments against a backbone.
// reads_flat/read_off: concatenated oriented read segments; read_col0[i] /
// read_col1[i] = the backbone span segment i covers.  Writes the consensus
// to cons_out (<= cons_cap) and returns its length; -1 for a gap-open bonus
// (go < 0), which the row form's insertion scan does not take.  stats[0..2]
// <- the active rows, the DP cells (each read's rows x band) and the rows
// that read a predecessor ranked later, summed over the reads.
int64_t telr_poa_consensus_rows(const int8_t* backbone, int64_t bb_len,
                                const int8_t* reads_flat,
                                const int64_t* read_off,
                                const int64_t* read_col0,
                                const int64_t* read_col1, int64_t n_reads,
                                int32_t W, int32_t ma, int32_t mi,
                                int32_t go, int32_t ge, int32_t min_cov,
                                int8_t* cons_out, int64_t cons_cap,
                                int64_t* stats) {
    stats[0] = stats[1] = stats[2] = 0;
    if (go < 0) return -1;
    poa::Graph g;
    int32_t prev = -1;
    for (int64_t i = 0; i < bb_len; i++) {
        int32_t v = g.add_node(backbone[i], (int32_t)i);
        g.insert_after(v, prev);
        if (prev >= 0) g.bump_edge(prev, v);
        // backbone edges start at weight 1 from bump; reset to 0 so the
        // consensus is carried by READ support, not the backbone itself
        if (prev >= 0) g.preds[v][0].w = 0;
        prev = v;
    }
    std::unordered_map<int64_t, int32_t> alt_at, ins_after;
    poa::RowWork w;
    for (int64_t r = 0; r < n_reads; r++) {
        const int8_t* seg = reads_flat + read_off[r];
        int64_t m = read_off[r + 1] - read_off[r];
        if (m <= 0) continue;
        poa::poa_add_read_rows(g, seg, m, read_col0[r], read_col1[r], W,
                               ma, mi, go, ge, alt_at, ins_after, w);
    }
    stats[0] = w.rows;
    stats[1] = w.cells;
    stats[2] = w.late_rows;
    return poa::poa_consensus_path(g, (int32_t)bb_len, min_cov,
                                   cons_out, cons_cap);
}

}  // extern "C"
