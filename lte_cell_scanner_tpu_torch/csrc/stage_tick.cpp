// stage_tick: the host staging of one tracker tick (tracker/batched.py,
// tracker/device_loop.py::stage_tick) in two native calls that write
// every section straight into the tick's staging buffer (on the card a
// reused pinned arena), in the byte layout the device program reads.
//
// stage_tick_inputs (span stage.inputs): per cell, its symbols'
// (fo, late, nse) rows and its initial phase, and either
//  - the raw route: the producer block, then an appendix of the windows
//    of symbols whose start is not in the block (straddlers, stale
//    blocks, chunks without starts), then one zero guard window that the
//    padding rows gather, zero-padded to a multiple of ext_bucket; as
//    [n_ext, 2] (re, im) planes, float16 when every value sits on the
//    8-bit ADC grid (ops/corr_cuda.py::is_adc_grid's rule, tested in the
//    pass that narrows), else float64; and each symbol's start;
//  - the window route: the [B, S, 128, 2] float64 windows.
// stage_tick_plan (span stage.plan): per cell, the (slot, sym) labels,
// CRS shifts, RS rows of each port and special rows of its symbols into
// a per-tick int64 buffer, and from them the gather tables rs_flat,
// rs_tab, spec_rows and spec_mask, their row axes rounded up to a
// multiple of rs_bucket.
//
// Both record the layout in lay[15] (byte offsets into the buffer, each
// a multiple of 64):
//   0 wire (0 float16, 1 float64)  1 n_ext (0 on the window route)
//   2 planes or windows  3 starts (-1 on the window route)  4 fln
//   5 init_phase  6 end of the inputs
//   7 P  8 NR  9 NQ  10 rs_flat  11 rs_tab  12 spec_rows  13 spec_mask
//   14 end of the plan: the bytes to upload
// and return 0, or, when the buffer's cap bytes would not hold the
// sections, the bytes needed, having written no byte of the buffer (the
// plan keeps what the inputs wrote below lay[6]).  The bytes between
// sections are never read.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX2__) && defined(__F16C__)
#include <immintrin.h>
#endif

namespace {

constexpr int64_t kAlign = 64;
constexpr double kTol = 1e-5;           // is_adc_grid's tol
constexpr double kLim = 128.0 + kTol;

int64_t align_up(int64_t n) { return (n + kAlign - 1) / kAlign * kAlign; }

int64_t bucket_up(int64_t n, int64_t b) {
    int64_t r = (n + b - 1) / b * b;
    return r > b ? r : b;
}

// numpy's float64 -> float16 cast (round to nearest even), bit for bit,
// NaN payloads included
uint16_t half_of(double x) {
    uint64_t d;
    std::memcpy(&d, &x, 8);
    uint16_t sgn = (uint16_t)((d & 0x8000000000000000ULL) >> 48);
    uint64_t e = d & 0x7ff0000000000000ULL;
    if (e >= 0x40f0000000000000ULL) {
        if (e == 0x7ff0000000000000ULL) {
            uint64_t sig = d & 0x000fffffffffffffULL;
            if (sig) {
                uint16_t r = (uint16_t)(0x7c00u + (sig >> 42));
                if (r == 0x7c00u) r++;
                return sgn + r;
            }
        }
        return sgn + 0x7c00u;
    }
    if (e <= 0x3f00000000000000ULL) {
        if (e < 0x3e60000000000000ULL) return sgn;
        e >>= 52;
        uint64_t sig = 0x0010000000000000ULL + (d & 0x000fffffffffffffULL);
        sig <<= (e - 998);
        if ((sig & 0x003fffffffffffffULL) != 0x0010000000000000ULL)
            sig += 0x0010000000000000ULL;
        return sgn + (uint16_t)(sig >> 53);
    }
    uint16_t h_exp = (uint16_t)((e - 0x3f00000000000000ULL) >> 42);
    uint64_t sig = d & 0x000fffffffffffffULL;
    if ((sig & 0x000007ffffffffffULL) != 0x0000020000000000ULL)
        sig += 0x0000020000000000ULL;
    return sgn + h_exp + (uint16_t)(sig >> 42);
}

// The grid test's findings, per plane (0 re, 1 im).  numpy takes the
// max over a plane, which is NaN when the plane holds a NaN, and a NaN
// max passes both of is_adc_grid's tests.
struct Grid {
    bool fail[2] = {false, false};
    bool nan[2] = {false, false};
    bool inexact = false;     // a value that float32 does not hold
    bool on() const {
        return (nan[0] || !fail[0]) && (nan[1] || !fail[1]);
    }
};

void test1(double x, int plane, Grid& g, uint16_t* dst) {
    double k = x * 128.0;
    if (std::fabs(k) > kLim || std::fabs(k - std::nearbyint(k)) > kTol)
        g.fail[plane] = true;
    if (x != x) g.nan[plane] = true;
    *dst = half_of(x);
}

// Test n values (interleaved re, im; n even) against the grid and write
// them as float16 in the same pass.  The vector loop narrows through
// float32: values that float32 holds exactly narrow in one rounding, so
// the float16 of their float32 is numpy's; the caller redoes the pass
// with half_of when g.inexact.
void narrow(const double* src, int64_t n, uint16_t* dst, Grid& g) {
    int64_t i = 0;
#if defined(__AVX2__) && defined(__F16C__)
    const __m256d s128 = _mm256_set1_pd(128.0);
    const __m256d lim = _mm256_set1_pd(kLim);
    const __m256d tol = _mm256_set1_pd(kTol);
    const __m256d mag = _mm256_castsi256_pd(
        _mm256_set1_epi64x(0x7fffffffffffffffLL));
    __m256d fail = _mm256_setzero_pd(), nan = fail, inexact = fail;
    for (; i + 8 <= n; i += 8) {
        __m128 f[2];
        for (int h = 0; h < 2; h++) {
            __m256d x = _mm256_loadu_pd(src + i + 4 * h);
            __m256d k = _mm256_mul_pd(x, s128);
            __m256d r = _mm256_round_pd(
                k, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
            fail = _mm256_or_pd(fail, _mm256_cmp_pd(
                _mm256_and_pd(k, mag), lim, _CMP_GT_OQ));
            fail = _mm256_or_pd(fail, _mm256_cmp_pd(
                _mm256_and_pd(_mm256_sub_pd(k, r), mag), tol, _CMP_GT_OQ));
            nan = _mm256_or_pd(nan, _mm256_cmp_pd(x, x, _CMP_UNORD_Q));
            f[h] = _mm256_cvtpd_ps(x);
            inexact = _mm256_or_pd(inexact, _mm256_cmp_pd(
                _mm256_cvtps_pd(f[h]), x, _CMP_NEQ_UQ));
        }
        _mm_storeu_si128(
            (__m128i*)(dst + i),
            _mm256_cvtps_ph(_mm256_set_m128(f[1], f[0]),
                            _MM_FROUND_TO_NEAREST_INT));
    }
    // lanes 0, 2 hold re and 1, 3 im: i and each lane's offset are even
    int fm = _mm256_movemask_pd(fail), nm = _mm256_movemask_pd(nan);
    g.fail[0] |= (fm & 5) != 0;
    g.fail[1] |= (fm & 10) != 0;
    g.nan[0] |= (nm & 5) != 0;
    g.nan[1] |= (nm & 10) != 0;
    g.inexact |= _mm256_movemask_pd(inexact) != 0;
#endif
    for (; i < n; i++) test1(src[i], (int)(i & 1), g, dst + i);
}

struct Segment {
    const double* src;
    int64_t n;          // doubles
};

}  // namespace

extern "C" {

// cells [B, 7]: each cell's (address of its windows [m, 128] complex128,
// of fo [m], of late [m], of starts [m] int64 or 0 when none is in the
// block, m, sym0, n_symb); phase [B]; raw [L] complex128, or null for
// the window route.
int64_t stage_tick_inputs(int64_t B, int64_t S, const int64_t* cells,
                          const double* phase, const double* raw, int64_t L,
                          int64_t ext_bucket, uint8_t* buf, int64_t cap,
                          int64_t* lay) {
    const bool route_raw = raw != nullptr;
    // the appendix: each cell's symbols whose window is not in the block
    int64_t n_app = 0;
    if (route_raw) {
        for (int64_t b = 0; b < B; b++) {
            const int64_t* st = (const int64_t*)cells[7 * b + 3];
            int64_t m = cells[7 * b + 4];
            for (int64_t i = 0; i < m; i++)
                if (!st || st[i] < 0 || st[i] > L - 128) n_app++;
        }
    }
    const int64_t pad_at = L + 128 * n_app;
    const int64_t n_ext = route_raw
        ? (pad_at + 128 + ext_bucket - 1) / ext_bucket * ext_bucket : 0;
    const int64_t o_starts = route_raw ? 0 : -1;
    const int64_t o_fln = route_raw ? align_up(8 * B * S) : 0;
    const int64_t o_phase = align_up(o_fln + 24 * B * S);
    const int64_t o_planes = align_up(o_phase + 8 * B);
    const int64_t n_win = route_raw ? 2 * n_ext : 256 * B * S;  // doubles
    const int64_t need = align_up(o_planes + 8 * n_win);  // float64 at most
    if (need > cap) return need;

    double* fln = (double*)(buf + o_fln);
    int64_t* starts = route_raw ? (int64_t*)(buf + o_starts) : nullptr;
    double* win = route_raw ? nullptr : (double*)(buf + o_planes);
    std::vector<Segment> segs;
    if (route_raw) segs.push_back({raw, 2 * L});
    int64_t app = 0;
    for (int64_t b = 0; b < B; b++) {
        const int64_t* c = cells + 7 * b;
        const double* data = (const double*)c[0];
        const double* fo = (const double*)c[1];
        const double* late = (const double*)c[2];
        const int64_t* st = (const int64_t*)c[3];
        const int64_t m = c[4], sym0 = c[5], n_symb = c[6];
        double* r_fo = fln + 3 * S * b;
        double* r_late = r_fo + S;
        double* r_nse = r_late + S;
        for (int64_t i = 0; i < m; i++) {
            r_fo[i] = fo[i];
            r_late[i] = late[i];
            // batched.py::n_samp_elapsed_of over the running symbol index
            r_nse[i] = n_symb == 6 ? 160.0
                : ((sym0 + i) % n_symb + n_symb) % n_symb == 0 ? 138.0
                : 137.0;
        }
        for (int64_t i = m; i < S; i++) r_fo[i] = r_late[i] = r_nse[i] = 0.0;
        if (route_raw) {
            int64_t* row = starts + S * b;
            for (int64_t i = 0; i < m; i++) {
                if (st && st[i] >= 0 && st[i] <= L - 128) {
                    row[i] = st[i];
                } else {
                    row[i] = L + 128 * app++;
                    segs.push_back({data + 256 * i, 256});
                }
            }
            for (int64_t i = m; i < S; i++) row[i] = pad_at;
        } else {
            double* w = win + 256 * S * b;
            std::memcpy(w, data, 8 * 256 * m);
            std::memset(w + 256 * m, 0, 8 * 256 * (S - m));
        }
    }
    std::memcpy(buf + o_phase, phase, 8 * B);

    bool f64 = !route_raw;
    if (route_raw) {
        uint16_t* h = (uint16_t*)(buf + o_planes);
        Grid g;
        int64_t at = 0;
        for (const Segment& s : segs) {
            narrow(s.src, s.n, h + at, g);
            at += s.n;
        }
        std::memset(h + at, 0, 2 * (n_win - at));
        f64 = !g.on();
        if (f64) {
            double* d = (double*)(buf + o_planes);
            at = 0;
            for (const Segment& s : segs) {
                std::memcpy(d + at, s.src, 8 * s.n);
                at += s.n;
            }
            std::memset(d + at, 0, 8 * (n_win - at));
        } else if (g.inexact) {
            at = 0;
            for (const Segment& s : segs)
                for (int64_t i = 0; i < s.n; i++) h[at++] = half_of(s.src[i]);
        }
    }
    lay[0] = f64;
    lay[1] = n_ext;
    lay[2] = o_planes;
    lay[3] = o_starts;
    lay[4] = o_fln;
    lay[5] = o_phase;
    lay[6] = align_up(o_planes + (f64 ? 8 : 2) * n_win);
    return 0;
}

// cells [B, 6]: each cell's (m, its first symbol's running index
// slot_num * n_symb + sym_num, n_symb, n_ports, address of its shift
// table [20, n_symb, 4] int64 (-1: no RS of that port), of its
// conjugated RS table [20, n_symb, 12] complex128).  plans (fresh, 5 B +
// 11 sum(m) int64): per cell (nr of ports 0-3, nq), then per cell its
// labels slot [m], sym [m], shifts [m, 4], RS rows of ports 0-3 [4, m]
// (the first nr of each), special rows [m] (the first nq).
int64_t stage_tick_plan(int64_t B, int64_t S, const int64_t* cells,
                        int64_t rs_bucket, int64_t* plans, uint8_t* buf,
                        int64_t cap, int64_t* lay) {
    int64_t nr_max = 1, nq_max = 1, P = 1;
    int64_t* body = plans + 5 * B;
    for (int64_t b = 0; b < B; b++) {
        const int64_t* c = cells + 6 * b;
        const int64_t m = c[0], k0 = c[1], n_symb = c[2], n_ports = c[3];
        const int64_t* shift = (const int64_t*)c[4];
        int64_t* slot = body;
        int64_t* sym = slot + m;
        int64_t* sh = sym + m;
        int64_t* rs = sh + 4 * m;
        int64_t* spec = rs + 4 * m;
        int64_t nr[4] = {0, 0, 0, 0}, nq = 0;
        for (int64_t i = 0; i < m; i++) {
            int64_t k = k0 + i;
            int64_t sl = (k / n_symb) % 20, sy = k % n_symb;
            slot[i] = sl;
            sym[i] = sy;
            const int64_t* t = shift + 4 * (sl * n_symb + sy);
            for (int p = 0; p < 4; p++) {
                sh[4 * i + p] = t[p];
                if (p < n_ports && t[p] >= 0) rs[p * m + nr[p]++] = i;
            }
            bool sync = (sl == 0 || sl == 10)
                && (sy == n_symb - 2 || sy == n_symb - 1);
            bool pbch = sl == 1 && sy <= 3;
            if (sync || pbch) spec[nq++] = i;
        }
        for (int p = 0; p < 4; p++) {
            plans[5 * b + p] = nr[p];
            if (nr[p] > nr_max) nr_max = nr[p];
        }
        plans[5 * b + 4] = nq;
        if (nq > nq_max) nq_max = nq;
        if (n_ports > P) P = n_ports;
        body += 11 * m;
    }
    const int64_t NR = bucket_up(nr_max, rs_bucket);
    const int64_t NQ = bucket_up(nq_max, rs_bucket);
    const int64_t o_flat = align_up(lay[6]);
    const int64_t o_tab = align_up(o_flat + 8 * B * P * NR * 12);
    const int64_t o_rows = align_up(o_tab + 8 * B * P * NR * 24);
    const int64_t o_mask = align_up(o_rows + 8 * B * NQ);
    const int64_t end = align_up(o_mask + 8 * B * NQ);
    if (end > cap) return end;

    int64_t* flat = (int64_t*)(buf + o_flat);
    double* tab = (double*)(buf + o_tab);
    int64_t* rows = (int64_t*)(buf + o_rows);
    double* mask = (double*)(buf + o_mask);
    std::memset(flat, 0, 8 * B * P * NR * 12);
    std::memset(tab, 0, 8 * B * P * NR * 24);
    std::memset(rows, 0, 8 * B * NQ);
    std::memset(mask, 0, 8 * B * NQ);
    body = plans + 5 * B;
    for (int64_t b = 0; b < B; b++) {
        const int64_t* c = cells + 6 * b;
        const int64_t m = c[0], n_symb = c[2], n_ports = c[3];
        const double* conj = (const double*)c[5];
        const int64_t* slot = body;
        const int64_t* sym = slot + m;
        const int64_t* sh = sym + m;
        const int64_t* rs = sh + 4 * m;
        const int64_t* spec = rs + 4 * m;
        for (int64_t p = 0; p < n_ports; p++) {
            for (int64_t j = 0; j < plans[5 * b + p]; j++) {
                int64_t i = rs[p * m + j];
                int64_t base = (b * S + i) * 72 + sh[4 * i + p];
                const double* t = conj + 24 * (slot[i] * n_symb + sym[i]);
                int64_t* f = flat + ((b * P + p) * NR + j) * 12;
                double* v = tab + ((b * P + p) * NR + j) * 24;
                for (int q = 0; q < 12; q++) f[q] = base + 6 * q;
                std::memcpy(v, t, 8 * 24);
            }
        }
        for (int64_t q = 0; q < plans[5 * b + 4]; q++) {
            rows[b * NQ + q] = b * S + spec[q];
            mask[b * NQ + q] = 1.0;
        }
        body += 11 * m;
    }
    lay[7] = P;
    lay[8] = NR;
    lay[9] = NQ;
    lay[10] = o_flat;
    lay[11] = o_tab;
    lay[12] = o_rows;
    lay[13] = o_mask;
    lay[14] = end;
    return 0;
}

}  // extern "C"
