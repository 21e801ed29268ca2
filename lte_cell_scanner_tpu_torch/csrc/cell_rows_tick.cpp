// cell_rows_tick: the device loop's cell tick (tracker/device_loop.py) in
// one call for all the cell's ports.  The device already extracted each
// port's raw-CE rows; per port, in port order (so the sequential
// FOE/frame-timing feedback chains exactly as the per-port loop does):
// 1. append the port's new rows to its pending rows;
// 2. run every complete RS 3-window through the runtime's port_tick
//    (native/tracker_math.cpp), the same call the per-port chain made;
// 3. keep the 2-row pending tail.
// Steps 2-3 and the per-port state follow cell_tick's of the runtime, so
// the device loop and the dense path leave the same state.
//
// In:  ce_rows [>=n_ports, nr, 24]: port p's n_rows[p] rows first, one
//      for each of the tick's symbols whose shift_table entry for p is
//      >= 0, in symbol order; slot_a/sym_a [n_new] labels; fo_a/ft_a
//      [n_new] PDU stamps; shift_table [20*n_symb*4] int64 (per-port RS
//      shift, -1 = no RS in that symbol).
// In/out per-port state, stacked on axis 0 = port: pend_* [P,cap(,24)]
//      + pend_cnt [P]; carry_* [P,...] + carry_valid [P]; hist
//      [P,72*24] + hist_pos [P]; shared ac_fd/ac_td/regs as port_tick's.
// Out: out_ce [P,cap_out,144], out_scal [P,4,cap_out] ({tp,sp,spr,np},
//      each contiguous), out_cnt [P] emitted counts, out_label0 [P,2]
//      the first seq label per port (for the Python-side bootstrap).
// Returns the total emitted rows, or -1 if a port's selection differs
// from n_rows[p] or cap/cap_out would be exceeded (the caller's bounds
// are sized so this cannot happen; a -1 is a bug trap).

#include <cstdint>

extern "C" {

int64_t port_tick(int64_t m, const double* ce, const int64_t* shift,
                  const int64_t* slot, const int64_t* sym, const double* fo,
                  const double* ft, int64_t has_carry, double* carry_ce72,
                  double* carry_scal, int64_t* carry_label, int64_t n_symb,
                  int64_t port_gt2, int64_t extended, double fs_lte,
                  double fc_requested, double fc_programmed,
                  double fs_programmed, double* ac_fd_state,
                  double* ac_td_state, double* hist, int64_t* hist_pos,
                  double* regs, double* out_ce, double* out_tp,
                  double* out_sp, double* out_spr, double* out_npv);

int64_t cell_rows_tick(
    int64_t n_new, const double* ce_rows, int64_t nr, const int64_t* n_rows,
    const int64_t* slot_a, const int64_t* sym_a, const double* fo_a,
    const double* ft_a, const int64_t* shift_table, int64_t n_ports,
    int64_t n_symb, int64_t extended, double fs_lte, double fc_requested,
    double fc_programmed, double fs_programmed, int64_t cap,
    double* pend_ce, int64_t* pend_shift, int64_t* pend_slot,
    int64_t* pend_sym, double* pend_fo, double* pend_ft, int64_t* pend_cnt,
    double* carry_ce72, double* carry_scal, int64_t* carry_label,
    int64_t* carry_valid, double* ac_fd_state, double* ac_td_state,
    double* hist, int64_t* hist_pos, double* regs, int64_t cap_out,
    double* out_ce, double* out_scal, int64_t* out_cnt,
    int64_t* out_label0) {
    int64_t total = 0;
    for (int64_t p = 0; p < n_ports; p++) {
        double* pce = pend_ce + p * cap * 24;
        int64_t* psh = pend_shift + p * cap;
        int64_t* psl = pend_slot + p * cap;
        int64_t* psy = pend_sym + p * cap;
        double* pfo = pend_fo + p * cap;
        double* pft = pend_ft + p * cap;
        int64_t cnt = pend_cnt[p];
        // 1. append the port's new rows
        if (n_rows[p] > nr) return -1;
        const double* rows = ce_rows + p * nr * 24;
        int64_t j = 0;
        for (int64_t i = 0; i < n_new; i++) {
            int64_t sh = shift_table[(slot_a[i] * n_symb + sym_a[i]) * 4 + p];
            if (sh < 0) continue;
            if (j >= n_rows[p] || cnt >= cap) return -1;
            for (int q = 0; q < 24; q++) pce[24 * cnt + q] = rows[24 * j + q];
            psh[cnt] = sh;
            psl[cnt] = slot_a[i];
            psy[cnt] = sym_a[i];
            pfo[cnt] = fo_a[i];
            pft[cnt] = ft_a[i];
            cnt++;
            j++;
        }
        if (j != n_rows[p]) return -1;
        // 2. process complete windows
        out_cnt[p] = 0;
        if (cnt >= 3) {
            // the seq labels: the carried row's, then each window
            // centre's (rows 1..cnt-2); the pair walk emits one row per
            // symbol between consecutive ones
            int64_t s0 = psl[1], y0 = psy[1], k0 = 2;
            if (carry_valid[p]) {
                s0 = carry_label[2 * p];
                y0 = carry_label[2 * p + 1];
                k0 = 1;
            }
            out_label0[2 * p] = s0;
            out_label0[2 * p + 1] = y0;
            int64_t need = 0;
            for (int64_t k = k0; k < cnt - 1; k++) {
                int64_t d = (((psl[k] - s0) % 20 + 20) % 20) * n_symb
                    + (psy[k] - y0);
                if (d > 0) need += d;
                s0 = psl[k];
                y0 = psy[k];
            }
            if (need > cap_out) return -1;
            double* osc = out_scal + p * 4 * cap_out;
            int64_t w = port_tick(
                cnt, pce, psh, psl, psy, pfo, pft, carry_valid[p],
                carry_ce72 + 144 * p, carry_scal + 4 * p,
                carry_label + 2 * p, n_symb, p > 2, extended, fs_lte,
                fc_requested, fc_programmed, fs_programmed, ac_fd_state,
                ac_td_state, hist + p * 72 * 24, hist_pos + p, regs,
                out_ce + p * cap_out * 144, osc, osc + cap_out,
                osc + 2 * cap_out, osc + 3 * cap_out);
            carry_valid[p] = 1;
            out_cnt[p] = w;
            total += w;
            // 3. keep the 2-row pending tail
            for (int64_t r = 0; r < 2; r++) {
                int64_t src = cnt - 2 + r;
                for (int q = 0; q < 24; q++)
                    pce[24 * r + q] = pce[24 * src + q];
                psh[r] = psh[src];
                psl[r] = psl[src];
                psy[r] = psy[src];
                pfo[r] = pfo[src];
                pft[r] = pft[src];
            }
            cnt = 2;
        }
        pend_cnt[p] = cnt;
    }
    return total;
}

}  // extern "C"
