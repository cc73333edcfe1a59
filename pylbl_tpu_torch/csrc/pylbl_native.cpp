// Native runtime components for pylbl_tpu.
//
// The TPU compute path is JAX/Pallas; this library covers the two pieces
// that are inherently host-side and serial:
//
// 1. parse_transitions_csv — the data-loader hot path: HITRAN transition
//    result files are multi-MB CSV (reference pyLBL parses them row by row
//    in Python, hitran_api.py:173-185); this parser is a single
//    allocation-free pass.
//
// 2. pedestal_scan — the only order-dependent stage of the spectrum
//    pipeline (reference spectra.c:66-78 subtracts, per line in processing
//    order, the min of the accumulated field at the window endpoints).
//    pylbl_tpu reduces it to a scalar scan with windowed bucket sums
//    (models/lines/pedestal.py); this is that scan, ~1000x the Python
//    loop, fed by the vectorized prefix terms computed in numpy/JAX.
//
// Built as a plain shared library (no Python headers) and bound via ctypes.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parses a HITRAN CSV results buffer with the ingestion parameter order
// (reference database.py:89-90): global_iso_id, molec_id, local_iso_id,
// nu, sw, gamma_air, gamma_self, n_air, delta_air, elower.
// Malformed rows are skipped (reference hitran_api.py:183-184).
// Returns the number of parsed rows (<= max_rows).
int64_t parse_transitions_csv(
    const char *text, int64_t length,
    int64_t *global_iso_id, int64_t *molec_id, int64_t *local_iso_id,
    double *nu, double *sw, double *gamma_air, double *gamma_self,
    double *n_air, double *delta_air, double *elower,
    int64_t max_rows)
{
    const char *p = text;
    const char *end = text + length;
    int64_t rows = 0;
    while (p < end && rows < max_rows)
    {
        // Skip empty lines.
        while (p < end && (*p == '\n' || *p == '\r' || *p == ' '))
        {
            ++p;
        }
        if (p >= end)
        {
            break;
        }
        const char *line_end = static_cast<const char *>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (line_end == nullptr)
        {
            line_end = end;
        }

        const char *q = p;
        bool ok = true;
        double fields[10];
        for (int f = 0; f < 10 && ok; ++f)
        {
            char *next = nullptr;
            double value = strtod(q, &next);
            if (next == q || next > line_end)
            {
                ok = false;
                break;
            }
            fields[f] = value;
            q = next;
            if (f < 9)
            {
                while (q < line_end && *q == ' ')
                {
                    ++q;
                }
                if (q >= line_end || *q != ',')
                {
                    ok = false;
                    break;
                }
                ++q;  // consume comma.
            }
        }
        if (ok)
        {
            global_iso_id[rows] = static_cast<int64_t>(fields[0]);
            molec_id[rows] = static_cast<int64_t>(fields[1]);
            local_iso_id[rows] = static_cast<int64_t>(fields[2]);
            nu[rows] = fields[3];
            sw[rows] = fields[4];
            gamma_air[rows] = fields[5];
            gamma_self[rows] = fields[6];
            n_air[rows] = fields[7];
            delta_air[rows] = fields[8];
            elower[rows] = fields[9];
            ++rows;
        }
        p = line_end + 1;
    }
    return rows;
}

// Sequential pedestal scan (semantics of reference spectra.c:66-78 after
// the parallel decomposition derived in models/lines/pedestal.py).
//
// Per line i (nu-sorted processing order):
//   k_s = left_clamp ? cum0_incl[i] - p0_running
//                    : k_s_contrib[i] - sum(bucket_ped[b_i-window .. b_i])
//   k_e = right_clamp ? cumN_incl[i] - pn_running
//                     : pre_contrib_e[i] - sum(bucket_ped[b_i .. b_i+window])
//   ped[i] = min(k_s, k_e); update bucket/edge accumulators.
//
// All contribution terms are precomputed (vectorized Voigt evaluations);
// this scan is pure O(window) bookkeeping per line.
void pedestal_scan(
    int64_t num_lines, int64_t window, int64_t num_buckets,
    const int64_t *bucket_rel,     // [N] b_i - b_min.
    const uint8_t *skip,           // [N] line contributes nothing.
    const uint8_t *left_clamp,     // [N] s_idx < 0.
    const uint8_t *right_clamp,    // [N] e_idx > n-1.
    const uint8_t *cover0,         // [N] window covers grid point 0.
    const uint8_t *coverN,         // [N] window covers grid point n-1.
    const double *k_s_contrib,     // [N] interior prefix field at p_s.
    const double *pre_contrib_e,   // [N] interior prefix field at p_e.
    const double *cum0_incl,       // [N] inclusive prefix field at point 0.
    const double *cumN_incl,       // [N] inclusive prefix field at n-1.
    double *bucket_ped,            // [num_buckets] scratch, zeroed here.
    double *ped)                   // [N] output.
{
    memset(bucket_ped, 0, sizeof(double) * static_cast<size_t>(num_buckets));
    double p0_running = 0.0;
    double pn_running = 0.0;
    for (int64_t i = 0; i < num_lines; ++i)
    {
        if (skip[i])
        {
            ped[i] = 0.0;
            continue;
        }
        int64_t b = bucket_rel[i];
        double k_s;
        if (left_clamp[i])
        {
            k_s = cum0_incl[i] - p0_running;
        }
        else
        {
            int64_t lo = b - window;
            if (lo < 0)
            {
                lo = 0;
            }
            double acc = 0.0;
            for (int64_t j = lo; j <= b; ++j)
            {
                acc += bucket_ped[j];
            }
            k_s = k_s_contrib[i] - acc;
        }
        double k_e;
        if (right_clamp[i])
        {
            k_e = cumN_incl[i] - pn_running;
        }
        else
        {
            int64_t hi = b + window + 1;
            if (hi > num_buckets)
            {
                hi = num_buckets;
            }
            double acc = 0.0;
            for (int64_t j = b; j < hi; ++j)
            {
                acc += bucket_ped[j];
            }
            k_e = pre_contrib_e[i] - acc;
        }
        double value = k_s < k_e ? k_s : k_e;
        ped[i] = value;
        bucket_ped[b] += value;
        if (cover0[i])
        {
            p0_running += value;
        }
        if (coverN[i])
        {
            pn_running += value;
        }
    }
}

}  // extern "C"
