// Native deterministic DP engine for tagdust_tpu.
//
// Implements the float32 table-logsum dynamic programs of the profile-HMM
// read-classification engine — backward, forward + max-posterior decoding
// with the optimal-accuracy label DP, and the generative emitters used by
// threshold calibration — over a *flat tensor* model layout (per segment:
// trans[H][C][9], emissions [H][C][5], entry tables [H][C]).
//
// Semantics mirror the reference C implementation (see
// the reference src/barcode_hmm.c: backward :3439, decoding :4128,
// emitters :2599/:2696) so results are bit-identical to its -DRTEST build;
// the data layout, batching API and parallelisation are new.  Must be
// compiled WITHOUT fp contraction or fast-math (see build flags in
// tagdust_tpu/engine/native.py) to keep strict IEEE float32 semantics.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int LOGSUM_SIZE = 16000;
float g_tbl[LOGSUM_SIZE];
bool g_tbl_init = false;

// transition slot indices
enum { MM = 0, MI = 1, MD = 2, II = 3, IM = 4, DD = 5, DM = 6, MSKIP = 7, ISKIP = 8 };

inline float logsum(float a, float b) {
    float mx = a > b ? a : b;
    float mn = a > b ? b : a;
    float d = mx - mn;
    if (mn == -INFINITY || d >= 15.7f) return mx;
    // d is >= 0 or NaN (NaN only from NaN/inf inputs on impossible reads);
    // the reference indexes its table with (int)NaN there — UB
    // (misc.c:72-78).  Defined choice matching logsum.py: slot 0.
    if (!(d >= 0.0f)) d = 0.0f;
    return mx + g_tbl[(int)(d * 1000.0f)];
}

inline float sp2p(float x) {
    if (x == -INFINITY) return 0.0f;
    return (float)exp((double)x);
}

struct Segment {
    int H, C;
    float skip;
    const float* trans;  // [H][C][9]
    const float* me;     // [H][C][5]
    const float* ie;     // [H][C][5]
    const float* s2M;    // [H][C]
    const float* s2I;    // [H][C]
};

struct Model {
    std::vector<Segment> segs;
    const int64_t* label;
    const float* tmatrix;  // [(Htot+1)][(Htot+1)]
    int Htot;
    int avg_len;
    const float* background;  // [5]
};

struct Scratch {
    // per (segment, hmm, column) DP slices, length L+2
    std::vector<float> Mf, If, Df, Mb, Ib, Db;
    std::vector<float> silent_f, silent_b, prev_silent;
    std::vector<float> dyn;       // (L+1) * Htot
    std::vector<int> path;        // (L+1) * Htot
    std::vector<float> total_prob;
    std::vector<int> state_off;   // per segment: offset of (h,c) slices
    int stride;                   // L+2

    void alloc(const Model& m, int L) {
        stride = L + 2;
        state_off.clear();
        int tot = 0;
        for (auto& s : m.segs) {
            state_off.push_back(tot);
            tot += s.H * s.C;
        }
        size_t n = (size_t)tot * stride;
        Mf.assign(n, -INFINITY);
        If.assign(n, -INFINITY);
        Df.assign(n, -INFINITY);
        Mb.assign(n, -INFINITY);
        Ib.assign(n, -INFINITY);
        Db.assign(n, -INFINITY);
        silent_f.assign((size_t)m.segs.size() * stride, -INFINITY);
        silent_b.assign((size_t)m.segs.size() * stride, -INFINITY);
        prev_silent.assign(stride, -INFINITY);
        dyn.assign((size_t)(L + 1) * m.Htot, -INFINITY);
        path.assign((size_t)(L + 1) * m.Htot, -1);
        total_prob.assign(m.Htot, -INFINITY);
    }
};

// ---------- backward (reference barcode_hmm.c:3439-3640) ----------
float run_backward(const Model& m, Scratch& sc, const uint8_t* seq, int L) {
    const int nm = (int)m.segs.size();
    const int st = sc.stride;
    std::fill(sc.Mb.begin(), sc.Mb.end(), -INFINITY);
    std::fill(sc.Ib.begin(), sc.Ib.end(), -INFINITY);
    std::fill(sc.Db.begin(), sc.Db.end(), -INFINITY);
    std::fill(sc.silent_b.begin(), sc.silent_b.end(), -INFINITY);
    std::fill(sc.prev_silent.begin(), sc.prev_silent.end(), -INFINITY);
    sc.prev_silent[L + 1] = 0.0f;

    sc.silent_b[(size_t)(nm - 1) * st + L + 1] = 0.0f + m.segs[nm - 1].skip;
    for (int j = nm - 2; j >= 0; j--)
        sc.silent_b[(size_t)j * st + L + 1] =
            sc.silent_b[(size_t)(j + 1) * st + L + 1] + m.segs[j].skip;

    for (int j = nm - 1; j >= 0; j--) {
        const Segment& sg = m.segs[j];
        const float* psilent =
            (j == nm - 1) ? sc.prev_silent.data() : &sc.silent_b[(size_t)(j + 1) * st];
        float* csilent = &sc.silent_b[(size_t)j * st];
        const int C = sg.C;
        const int last = C - 1;
        for (int f = 0; f < sg.H; f++) {
            const float* tr = sg.trans + (size_t)f * C * 9;
            const float* me = sg.me + (size_t)f * C * 5;
            const float* ie = sg.ie + (size_t)f * C * 5;
            const float* s2M = sg.s2M + (size_t)f * C;
            const float* s2I = sg.s2I + (size_t)f * C;
            float* MB = &sc.Mb[(size_t)(sc.state_off[j] + f * C) * st];
            float* IB = &sc.Ib[(size_t)(sc.state_off[j] + f * C) * st];
            float* DB = &sc.Db[(size_t)(sc.state_off[j] + f * C) * st];
            for (int i = L; i > 0; i--) {
                int c = seq[i];        // seqa[i+1]; i==L reads terminator 'A'
                int cp = seq[i - 1];   // seqa[i]
                // last column
                MB[(size_t)last * st + i] = psilent[i + 1] + tr[last * 9 + MSKIP];
                float v = psilent[i + 1] + tr[last * 9 + ISKIP];
                v = logsum(v, MB[(size_t)last * st + i + 1] + tr[last * 9 + IM] + me[last * 5 + c]);
                v = logsum(v, IB[(size_t)last * st + i + 1] + tr[last * 9 + II] + ie[last * 5 + c]);
                IB[(size_t)last * st + i] = v;
                csilent[i] = logsum(csilent[i], MB[(size_t)last * st + i] + s2M[last] + me[last * 5 + cp]);
                csilent[i] = logsum(csilent[i], IB[(size_t)last * st + i] + s2I[last] + ie[last * 5 + cp]);
                DB[(size_t)last * st + i] = -INFINITY;
                for (int g = last - 1; g >= 0; g--) {
                    v = MB[(size_t)(g + 1) * st + i + 1] + me[(g + 1) * 5 + c] + tr[g * 9 + MM];
                    v = logsum(v, psilent[i + 1] + tr[g * 9 + MSKIP]);
                    v = logsum(v, IB[(size_t)g * st + i + 1] + ie[g * 5 + c] + tr[g * 9 + MI]);
                    v = logsum(v, DB[(size_t)(g + 1) * st + i] + tr[g * 9 + MD]);
                    MB[(size_t)g * st + i] = v;
                    v = IB[(size_t)g * st + i + 1] + tr[g * 9 + II] + ie[g * 5 + c];
                    v = logsum(v, psilent[i + 1] + tr[g * 9 + ISKIP]);
                    v = logsum(v, MB[(size_t)(g + 1) * st + i + 1] + tr[g * 9 + IM] + me[(g + 1) * 5 + c]);
                    IB[(size_t)g * st + i] = v;
                    v = DB[(size_t)(g + 1) * st + i] + tr[g * 9 + DD];
                    v = logsum(v, MB[(size_t)(g + 1) * st + i] + me[(g + 1) * 5 + cp] + tr[g * 9 + DM]);
                    DB[(size_t)g * st + i] = v;
                    csilent[i] = logsum(csilent[i], MB[(size_t)g * st + i] + s2M[g] + me[g * 5 + cp]);
                    csilent[i] = logsum(csilent[i], IB[(size_t)g * st + i] + s2I[g] + ie[g * 5 + cp]);
                }
                csilent[i] = logsum(csilent[i], psilent[i] + sg.skip);
            }
        }
    }
    return sc.silent_b[0 * st + 1];
}

// ---------- forward + max posterior decoding (reference :4128-4525) ----------
void run_decode(const Model& m, Scratch& sc, const uint8_t* seq, int L,
                float b_score, float* f_score, float* bar_prob, int32_t* labels,
                float* r_score) {
    const int nm = (int)m.segs.size();
    const int st = sc.stride;
    const int Htot = m.Htot;
    std::fill(sc.Mf.begin(), sc.Mf.end(), -INFINITY);
    std::fill(sc.If.begin(), sc.If.end(), -INFINITY);
    std::fill(sc.Df.begin(), sc.Df.end(), -INFINITY);
    std::fill(sc.silent_f.begin(), sc.silent_f.end(), -INFINITY);
    std::fill(sc.dyn.begin(), sc.dyn.end(), -INFINITY);
    std::fill(sc.path.begin(), sc.path.end(), -1);
    std::fill(sc.total_prob.begin(), sc.total_prob.end(), -INFINITY);
    std::fill(sc.prev_silent.begin(), sc.prev_silent.end(), -INFINITY);
    sc.prev_silent[0] = 0.0f;

    sc.silent_f[0] = 0.0f + m.segs[0].skip;
    for (int j = 1; j < nm; j++)
        sc.silent_f[(size_t)j * st] = sc.silent_f[(size_t)(j - 1) * st] + m.segs[j].skip;

    int hc = 0;
    for (int j = 0; j < nm; j++) {
        const Segment& sg = m.segs[j];
        const float* psilent =
            (j == 0) ? sc.prev_silent.data() : &sc.silent_f[(size_t)(j - 1) * st];
        float* csilent = &sc.silent_f[(size_t)j * st];
        const int C = sg.C;
        for (int f = 0; f < sg.H; f++) {
            const float* tr = sg.trans + (size_t)f * C * 9;
            const float* me = sg.me + (size_t)f * C * 5;
            const float* ie = sg.ie + (size_t)f * C * 5;
            const float* s2M = sg.s2M + (size_t)f * C;
            const float* s2I = sg.s2I + (size_t)f * C;
            float* MF = &sc.Mf[(size_t)(sc.state_off[j] + f * C) * st];
            float* IF = &sc.If[(size_t)(sc.state_off[j] + f * C) * st];
            float* DF = &sc.Df[(size_t)(sc.state_off[j] + f * C) * st];
            float* MB = &sc.Mb[(size_t)(sc.state_off[j] + f * C) * st];
            float* IB = &sc.Ib[(size_t)(sc.state_off[j] + f * C) * st];
            for (int i = 1; i <= L; i++) {
                int c = seq[i - 1];  // seqa[i]
                float* dyn_i = &sc.dyn[(size_t)i * Htot];
                // column 0
                MF[i] = psilent[i - 1] + s2M[0] + me[0 * 5 + c];
                float post = MF[i] + MB[i] - b_score;
                sc.total_prob[hc] = logsum(sc.total_prob[hc], post);
                dyn_i[hc] = logsum(dyn_i[hc], post);
                float v = psilent[i - 1] + s2I[0];
                v = logsum(v, IF[i - 1] + tr[0 * 9 + II]);
                v = logsum(v, MF[i - 1] + tr[0 * 9 + MI]);
                IF[i] = v + ie[0 * 5 + c];
                float tpost = psilent[i - 1] + s2I[0] + ie[0 * 5 + c] + IB[i] - b_score;
                sc.total_prob[hc] = logsum(sc.total_prob[hc], tpost);
                dyn_i[hc] = logsum(dyn_i[hc], IF[i] + IB[i] - b_score);
                DF[i] = -INFINITY;
                csilent[i] = logsum(csilent[i], MF[i] + tr[0 * 9 + MSKIP]);
                csilent[i] = logsum(csilent[i], IF[i] + tr[0 * 9 + ISKIP]);
                for (int g = 1; g < C; g++) {
                    float* MFg = MF + (size_t)g * st;
                    float* IFg = IF + (size_t)g * st;
                    float* DFg = DF + (size_t)g * st;
                    const float* MFp = MF + (size_t)(g - 1) * st;
                    const float* IFp = IF + (size_t)(g - 1) * st;
                    const float* DFp = DF + (size_t)(g - 1) * st;
                    v = psilent[i - 1] + s2M[g];
                    v = logsum(v, MFp[i - 1] + tr[(g - 1) * 9 + MM]);
                    v = logsum(v, IFp[i - 1] + tr[(g - 1) * 9 + IM]);
                    v = logsum(v, DFp[i] + tr[(g - 1) * 9 + DM]);
                    MFg[i] = v + me[g * 5 + c];
                    dyn_i[hc] = logsum(dyn_i[hc], MFg[i] + MB[(size_t)g * st + i] - b_score);
                    v = psilent[i - 1] + s2I[g];
                    v = logsum(v, IFg[i - 1] + tr[g * 9 + II]);
                    v = logsum(v, MFg[i - 1] + tr[g * 9 + MI]);
                    IFg[i] = v + ie[g * 5 + c];
                    dyn_i[hc] = logsum(dyn_i[hc], IFg[i] + IB[(size_t)g * st + i] - b_score);
                    v = MFp[i] + tr[(g - 1) * 9 + MD];
                    v = logsum(v, DFp[i] + tr[(g - 1) * 9 + DD]);
                    DFg[i] = v;
                    csilent[i] = logsum(csilent[i], MFg[i] + tr[g * 9 + MSKIP]);
                    csilent[i] = logsum(csilent[i], IFg[i] + tr[g * 9 + ISKIP]);
                }
                csilent[i] = logsum(csilent[i], psilent[i] + sg.skip);
            }
            hc++;
        }
    }
    *f_score = sc.silent_f[(size_t)(nm - 1) * st + L];

    // barcode probability (:4354-4429)
    hc = 0;
    for (int j = 0; j < nm; j++) {
        const Segment& sg = m.segs[j];
        if (sg.H > 1) {
            int g0 = hc;
            float ns1 = -INFINITY;
            for (int f = 0; f < sg.H; f++) {
                ns1 = logsum(ns1, sc.total_prob[hc]);
                hc++;
            }
            for (int f = 0; f < sg.H; f++) {
                sc.total_prob[g0] = sc.total_prob[g0] - ns1;
                g0++;
            }
        } else {
            hc += sg.H;
        }
    }
    hc = 0;
    int g_flag = 1;
    float ns0 = -INFINITY;
    float ns2 = 0.0f;
    for (int j = 0; j < nm; j++) {
        const Segment& sg = m.segs[j];
        if (sg.H > 1) {
            g_flag = 0;
            float ns1 = -INFINITY;
            for (int f = 0; f < sg.H; f++) {
                if (sc.total_prob[hc] > ns0 && f != sg.H - 1) ns0 = sc.total_prob[hc];
                ns1 = logsum(ns1, sc.total_prob[hc]);
                hc++;
            }
            ns0 = ns0 - ns1;
            ns2 = ns2 + ns0;
        } else {
            hc += sg.H;
        }
    }
    if (g_flag)
        *bar_prob = 0.0f;
    else
        *bar_prob = (ns2 > 0) ? 0.0f : ns2;

    // label DP in probability space (:4431-4514)
    for (size_t k = 0; k < sc.dyn.size(); k++) sc.dyn[k] = sp2p(sc.dyn[k]);
    for (int i = 1; i <= L; i++) {
        const float* prev = &sc.dyn[(size_t)(i - 1) * Htot];
        float* cur = &sc.dyn[(size_t)i * Htot];
        int* pth = &sc.path[(size_t)i * Htot];
        for (int jl = 0; jl < Htot; jl++) {
            float mx = -1.0f;
            int mv = -1;
            for (int cc = 0; cc <= jl; cc++) {
                float tmp = prev[cc] * m.tmatrix[(size_t)cc * (Htot + 1) + jl];
                if (tmp > mx) {
                    mv = cc;
                    mx = tmp;
                }
                if (tmp == mx && cc == jl) {
                    mv = cc;
                    mx = tmp;
                }
            }
            cur[jl] += mx;
            pth[jl] = mv;
        }
    }
    {
        float mx = -1.0f;
        int mv = 0;
        const float* lastrow = &sc.dyn[(size_t)L * Htot];
        for (int jl = 0; jl < Htot; jl++)
            if (lastrow[jl] > mx) {
                mx = lastrow[jl];
                mv = jl;
            }
        for (int i = 0; i <= L; i++) labels[i] = 0;
        labels[L] = mv;
        int move = mv;
        for (int i = L; i > 0; i--) {
            // all-NaN dyn rows (impossible reads: P(x|M)=0, b_score=-inf)
            // leave path entries at -1; the reference reads out of bounds
            // there (barcode_hmm.c:4510 with a stale/-1 move — UB).  Such
            // reads are always rejected by the NaN-Q threshold gate, so a
            // defined clamp changes no observable output.
            if (move < 0 || move >= Htot) move = 0;
            move = sc.path[(size_t)i * Htot + move];
            labels[i - 1] = move;
        }
    }

    // random-model score (:4516-4523); prob2scaledprob narrows its argument
    // to float before the double log
    {
        float rs = 0.0f;
        float a = (float)(1.0 - (1.0 / (double)(float)m.avg_len));
        float per = (float)log((double)a);
        for (int i = 1; i <= L; i++) {
            int c = seq[i - 1];
            rs = rs + m.background[c] + per;
        }
        float bterm = (float)(1.0 / (double)(float)m.avg_len);
        rs += (float)log((double)bterm);
        *r_score = rs;
    }
}

Model build_model(int nm, const int* H, const int* C, const float* skip,
                  const float* trans, const float* me, const float* ie,
                  const float* s2M, const float* s2I, const int64_t* label,
                  const float* tmatrix, int Htot, int avg_len,
                  const float* background) {
    Model m;
    size_t o9 = 0, o5 = 0, o1 = 0;
    for (int j = 0; j < nm; j++) {
        Segment s;
        s.H = H[j];
        s.C = C[j];
        s.skip = skip[j];
        s.trans = trans + o9;
        s.me = me + o5;
        s.ie = ie + o5;
        s.s2M = s2M + o1;
        s.s2I = s2I + o1;
        o9 += (size_t)s.H * s.C * 9;
        o5 += (size_t)s.H * s.C * 5;
        o1 += (size_t)s.H * s.C;
        m.segs.push_back(s);
    }
    m.label = label;
    m.tmatrix = tmatrix;
    m.Htot = Htot;
    m.avg_len = avg_len;
    m.background = background;
    return m;
}

}  // namespace

extern "C" {

void td_init(void) {
    if (!g_tbl_init) {
        for (int i = 0; i < LOGSUM_SIZE; i++)
            g_tbl[i] = (float)log(1.0 + exp((double)-i / 1000.0f));
        g_tbl_init = true;
    }
}

// mode 0: backward + decode (full); mode 1: backward only (b_score)
void td_score_batch(int nm, const int* H, const int* C, const float* skip,
                    const float* trans, const float* me, const float* ie,
                    const float* s2M, const float* s2I, const int64_t* label,
                    const float* tmatrix, int Htot, int avg_len,
                    const float* background, const uint8_t* seqs, int B, int L,
                    int mode, float* f_score, float* b_score, float* r_score,
                    float* bar_prob, int32_t* labels_out, int nthreads) {
    td_init();
    Model m = build_model(nm, H, C, skip, trans, me, ie, s2M, s2I, label,
                          tmatrix, Htot, avg_len, background);
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel
#endif
    {
        Scratch sc;
        sc.alloc(m, L);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
        for (int b = 0; b < B; b++) {
            const uint8_t* seq = seqs + (size_t)b * (L + 1);
            float bs = run_backward(m, sc, seq, L);
            b_score[b] = bs;
            if (mode == 0) {
                run_decode(m, sc, seq, L, bs, &f_score[b], &bar_prob[b],
                           labels_out + (size_t)b * (L + 1), &r_score[b]);
            }
        }
    }
}

// ---- RTEST LCG (reference misc.c:878-887) ----
static inline int my_rand(uint32_t* state) {
    *state = (*state) * 1103515245u + 12345u;
    return (int)((*state / 65536u) % 32768u);
}

// emit a sequence from the background random model
// (reference barcode_hmm.c:2599-2680); advances *state in place
static void emit_random_core(const float* background, uint32_t* state,
                             int avg_len, uint8_t* out, int cap,
                             int* out_len) {
    double r = (double)((float)my_rand(state) / 32768.0f);
    int cl = 0;
    double cont = 1.0 - (1.0 / (double)(float)avg_len);
    while (cl < avg_len) {
        for (;;) {
            float s = -INFINITY;
            for (int nuc = 0; nuc < 5; nuc++) {
                s = logsum(s, background[nuc]);
                if (r < (double)sp2p(s)) {
                    if (cl < cap) out[cl] = (uint8_t)nuc;
                    cl++;
                    break;
                }
            }
            r = (double)((float)my_rand(state) / 32768.0f);
            if (r > cont) break;
        }
        if (cl < avg_len) cl = 0;
    }
    *out_len = cl;
}

uint32_t td_emit_random(const float* background, uint32_t state, int avg_len,
                        uint8_t* out, int cap, int* out_len) {
    td_init();
    emit_random_core(background, &state, avg_len, out, cap, out_len);
    return state;
}

// batched emission: one call emits n reads into out[n*cap] rows, storing
// each read's true length in out_lens[k] (bases past cap are counted, not
// written) and the rng state AT ENTRY of read k in entry_states[k] — a
// truncated outlier can be re-emitted alone from its entry state without
// disturbing the draw-for-draw LCG parity of the rest of the batch.
// 400k single-read ctypes calls cost ~24s of every default-flag run; one
// call per 32k-read slab removes that entirely.
uint32_t td_emit_random_batch(const float* background, uint32_t state,
                              int avg_len, int n, uint8_t* out, int cap,
                              int* out_lens, uint32_t* entry_states) {
    td_init();
    for (int k = 0; k < n; k++) {
        entry_states[k] = state;
        emit_random_core(background, &state, avg_len, out + (size_t)k * cap,
                         cap, out_lens + k);
    }
    return state;
}

// emit a sequence generatively from the architecture HMM
// (reference barcode_hmm.c:2696-3046); advances *state in place
static void emit_read_core(const Model& m, int nm, uint32_t* stptr,
                           int avg_len, uint8_t* out, int cap,
                           int* out_len) {
    uint32_t state = *stptr;
    (void)my_rand(&state);  // entry draw, unused (:2721)
    int cl = 0;
    while (cl < avg_len) {
        int st = 0, column = 0, hmm = 0, segment = 0;
        for (;;) {
            double r = (double)((float)my_rand(&state) / 32768.0f);
            if (st == 0) {
                const Segment& sg = m.segs[segment];
                float s = -INFINITY;
                bool done = false;
                for (int i = 0; i < sg.H && !done; i++) {
                    for (int j = 0; j < sg.C; j++) {
                        s = logsum(s, sg.s2M[(size_t)i * sg.C + j]);
                        if (r < (double)sp2p(s)) {
                            st = 1; column = j; hmm = i; done = true; break;
                        }
                        s = logsum(s, sg.s2I[(size_t)i * sg.C + j]);
                        if (r < (double)sp2p(s)) {
                            st = 2; column = j; hmm = i; done = true; break;
                        }
                    }
                }
            } else if (st == 1) {
                const Segment& sg = m.segs[segment];
                const float* tr = sg.trans + ((size_t)hmm * sg.C + column) * 9;
                float s = logsum(-INFINITY, tr[MM]);
                if (r < (double)sp2p(s)) {
                    st = 1; column++;
                } else {
                    s = logsum(s, tr[MI]);
                    if (r < (double)sp2p(s)) {
                        st = 2;
                    } else {
                        s = logsum(s, tr[MD]);
                        if (r < (double)sp2p(s)) {
                            st = 3; column++;
                        } else {
                            st = 0; segment++; column = 0; hmm = 0;
                        }
                    }
                }
            } else if (st == 2) {
                const Segment& sg = m.segs[segment];
                const float* tr = sg.trans + ((size_t)hmm * sg.C + column) * 9;
                float s = logsum(-INFINITY, tr[II]);
                if (r < (double)sp2p(s)) {
                    st = 2;
                } else {
                    s = logsum(s, tr[IM]);
                    if (r < (double)sp2p(s)) {
                        st = 1; column++;
                    } else {
                        st = 0; segment++; column = 0; hmm = 0;
                    }
                }
            } else if (st == 3) {
                const Segment& sg = m.segs[segment];
                const float* tr = sg.trans + ((size_t)hmm * sg.C + column) * 9;
                float s = logsum(-INFINITY, tr[DD]);
                if (r < (double)sp2p(s)) {
                    st = 3; column++;
                } else {
                    st = 1; column++;
                }
            }
            // emission draw every iteration (:2939)
            r = (double)((float)my_rand(&state) / 32768.0f);
            if (st == 1 && segment < nm) {
                const Segment& sg = m.segs[segment];
                const float* em = sg.me + ((size_t)hmm * sg.C + column) * 5;
                float s = -INFINITY;
                for (int nuc = 0; nuc < 5; nuc++) {
                    s = logsum(s, em[nuc]);
                    if (r < (double)sp2p(s)) {
                        if (cl < cap) out[cl] = (uint8_t)nuc;
                        cl++;
                        break;
                    }
                }
            } else if (st == 2 && segment < nm) {
                const Segment& sg = m.segs[segment];
                const float* em = sg.ie + ((size_t)hmm * sg.C + column) * 5;
                float s = -INFINITY;
                for (int nuc = 0; nuc < 5; nuc++) {
                    s = logsum(s, em[nuc]);
                    if (r < (double)sp2p(s)) {
                        if (cl < cap) out[cl] = (uint8_t)nuc;
                        cl++;
                        break;
                    }
                }
            }
            if (segment == nm) break;
        }
        if (cl < avg_len) cl = 0;
    }
    *out_len = cl;
    *stptr = state;
}

uint32_t td_emit_read(int nm, const int* H, const int* C, const float* skip,
                      const float* trans, const float* me, const float* ie,
                      const float* s2M, const float* s2I, uint32_t state,
                      int avg_len, uint8_t* out, int cap, int* out_len) {
    td_init();
    Model m = build_model(nm, H, C, skip, trans, me, ie, s2M, s2I, nullptr,
                          nullptr, 0, avg_len, nullptr);
    emit_read_core(m, nm, &state, avg_len, out, cap, out_len);
    return state;
}

// batched counterpart of td_emit_read — see td_emit_random_batch
uint32_t td_emit_read_batch(int nm, const int* H, const int* C,
                            const float* skip, const float* trans,
                            const float* me, const float* ie,
                            const float* s2M, const float* s2I,
                            uint32_t state, int avg_len, int n, uint8_t* out,
                            int cap, int* out_lens, uint32_t* entry_states) {
    td_init();
    Model m = build_model(nm, H, C, skip, trans, me, ie, s2M, s2I, nullptr,
                          nullptr, 0, avg_len, nullptr);
    for (int k = 0; k < n; k++) {
        entry_states[k] = state;
        emit_read_core(m, nm, &state, avg_len, out + (size_t)k * cap, cap,
                       out_lens + k);
    }
    return state;
}

}  // extern "C"
