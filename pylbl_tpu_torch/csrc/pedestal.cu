// Hand-written Hopper kernels of the stacked pedestal remover.
//
// Built with csrc/lineshape.cu into one library by
// pylbl_tpu_torch/ops/lineshape_cuda.py (same nvcc flags: -O3 -std=c++17
// -gencode arch=compute_90a,code=sm_90a -fmad=false, no --use_fast_math)
// and bound with ctypes by pylbl_tpu_torch/ops/pedestal_cuda.py, whose
// plain PyTorch versions they equal.  They replace no TPU kernel: the JAX
// package runs the pedestal's float64 physics and its scan on the host
// (pylbl_tpu/models/lines/pedestal.py, parallel/lines.py
// make_stacked_pedestal_remover).  Here the remover keeps its work on the
// card, each gas on a stream of its own, in five launches over the gas's
// layer batch [B, N] (lines in processing order, float64, -fmad=false so
// each a*b + c rounds twice, as the plain versions and the host do); none
// syncs with the host and none uses float atomics, so runs are
// bit-identical.
//
// pedestal_lines_kernel (P): the float64 line physics, a thread a (layer,
//   line): the window's bucket and ends, the center, widths and strength
//   (models/lines/physics.py).  Bound: the constants read and the [B, N]
//   results written once.
// pedestal_contrib_kernel (A): the order-independent terms of the scan
//   (models/lines/pedestal.py compute_pedestals_batch).  Every line of a
//   bucket b has the same window, so the same endpoints p_s(b), p_e(b) and
//   the same local segment [seg_lo, seg_hi) (the lines within the batch's
//   largest shift of b's wavenumber): a thread owns a (layer, bucket) and
//   walks its segment twice, the terms pref_j * K(x_j(p), y_j) of the
//   lines whose window holds the endpoint: up, adding at p_e and handing
//   each line of the bucket the sum through it; down, adding at p_s and
//   handing each line k(p_s) less the sum past it, and its own terms at
//   points 0 and n - 1 (for the edge sums).  So a line's sums cost one
//   walk of its bucket's segment, not one a line.  K is the Lorentzian
//   unless |x| < xlim0(y) and y < 70.55, where it is voigt_full's Humlicek
//   region (ops/voigt.py, the same operations in float64): the choice is
//   made in registers, with no list and no host sync.  Bound: two terms a
//   line and a segment, about 9 float64 operations each, a divide among
//   them.
// pedestal_scan_kernel (B): the order-dependent remainder, the native
//   scan's rule (csrc/pylbl_native.cpp pedestal_scan): min(k_s, k_e) per
//   line, bucket windows of 2 * cut_off + 1.  One block a (layer) row:
//   warp 0's first lane scans while warps 1-3 stage the next tile of lines
//   into shared memory; the row's bucket totals live in shared memory
//   where they fit (else in device memory).  Its sums are the native
//   scan's, bit for bit, in fewer operations: the left window sum keeps
//   its part below the line's bucket while no bucket there changes (the
//   native sum adds the line's bucket last), the right window stops at
//   the highest bucket any line has touched (the buckets above hold +0.0,
//   and a sum that starts at +0.0 never holds -0.0, so adding them
//   changes nothing), and the line's bucket total stays in a register
//   while lines share it: a run of lines inside the grid after such a
//   line of their bucket (marked while staging, the runs counted by warp
//   1's ballots) takes its dependent chain alone, in a tight loop.
//   Bound: that chain, a row's lines in series (not a rate of the card).
// pedestal_totals_kernel (D): the field's bucket totals, a thread a
//   (layer, bucket) adding its lines' pedestals in line order from +0.0,
//   each first rounded to float32 where the field is float32, as the
//   host's remover and the JAX package's round them before their
//   subtraction (in the scan's chain the two conversions cost a third
//   of its time).  Bound: the pedestals read once.
// pedestal_field_kernel (C): the pedestal field and its subtraction.  Every
//   window is anchored at its line's integer bucket b, so the windows of
//   one bucket are one window and the field at a point p is the sum of the
//   bucket totals of the buckets whose window holds p, at most
//   2 * cut_off + 2 of them (blo[p] .. bhi[p], absolute buckets, from the
//   host).  A thread owns a (layer, point) and adds them in bucket order
//   from +0.0 in float64, then subtracts the sum cast to the field's type.
//   No scatter, no atomics.  Bound: the field read and written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kContribThreads = 256;
// The scan: a block of 4 warps (warp 0 scans, warps 1-3 stage), lines a
// staged tile, four float64 inputs and four int32s (three and a flag) a
// line.
constexpr int kScanThreads = 128;
constexpr int kScanTile = 512;
constexpr size_t kScanStage = 2 * (size_t)kScanTile * (4 * sizeof(double)
                                                       + 4 * sizeof(int));
constexpr int kFieldThreads = 256;
// Above every xlim0(y) (ops/voigt.py XLIM0_MAX, 123.33): a term with |x|
// at or beyond it is the Lorentzian without computing xlim0.
constexpr double kXlimBound = 124.0;

// ---- voigt_full's regions in float64 (ops/voigt.py, same op order) ----

__device__ __forceinline__ double safe_div(double num, double den)
{
    return num / (den == 0.0 ? 1.0 : den);
}

__device__ __forceinline__ double region1(double xq, double y, double yq,
                                          double rsqrpi)
{
    const double a0 = yq + 0.5;
    const double d0 = a0 * a0;
    const double d2 = (yq + yq) - 1.0;
    const double den = d0 + xq * (d2 + xq);
    return safe_div((rsqrpi * y) * (a0 + xq), den);
}

__device__ __forceinline__ double region2(double xq, double y, double yq,
                                          double rsqrpi)
{
    const double h0 = 0.5625 + yq * (4.5 + yq * (10.5 + yq * (6.0 + yq)));
    const double h2 = -4.5 + yq * (9.0 + yq * (6.0 + yq * 4.0));
    const double h4 = 10.5 - yq * (6.0 - yq * 6.0);
    const double h6 = -6.0 + yq * 4.0;
    const double e0 = 1.875 + yq * (8.25 + yq * (5.5 + yq));
    const double e2 = 5.25 + yq * (1.0 + yq * 3.0);
    const double e4 = 0.75 * h6;
    const double den = h0 + xq * (h2 + xq * (h4 + xq * (h6 + xq)));
    return safe_div((y * (e0 + xq * (e2 + xq * (e4 + xq)))) * rsqrpi, den);
}

__device__ __forceinline__ double region3(double xq, double y)
{
    const double z0 = 272.1014 + y * (1280.829 + y * (2802.870
        + y * (3764.966 + y * (3447.629 + y * (2256.981 + y * (1074.409
        + y * (369.1989 + y * (88.26741 + y * (13.39880 + y)))))))));
    const double z2 = 211.678 + y * (902.3066 + y * (1758.336
        + y * (2037.310 + y * (1549.675 + y * (793.4273 + y * (266.2987
        + y * (53.59518 + y * 5.0)))))));
    const double z4 = 78.86585 + y * (308.1852 + y * (497.3014
        + y * (479.2576 + y * (269.2916 + y * (80.39278 + y * 10.0)))));
    const double z6 = 22.03523 + y * (55.02933 + y * (92.75679
        + y * (53.59518 + y * 10.0)));
    const double z8 = 1.496460 + y * (13.39880 + y * 5.0);
    const double p0 = 153.5168 + y * (549.3954 + y * (919.4955
        + y * (946.8970 + y * (662.8097 + y * (328.2151 + y * (115.3772
        + y * (27.93941 + y * (4.264678 + y * 0.3183291))))))));
    const double p2 = -34.16955 + y * (-1.322256 + y * (124.5975
        + y * (189.7730 + y * (139.4665 + y * (56.81652 + y * (12.79458
        + y * 1.2733163))))));
    const double p4 = 2.584042 + y * (10.46332 + y * (24.01655
        + y * (29.81482 + y * (12.79568 + y * 1.9099744))));
    const double p6 = -0.07272979 + y * (0.9377051 + y * (4.266322
        + y * 1.273316));
    const double p8 = 0.0005480304 + y * 0.3183291;
    const double den = z0 + xq * (z2 + xq * (z4 + xq * (z6 + xq * (z8
        + xq))));
    const double num = p0 + xq * (p2 + xq * (p4 + xq * (p6 + xq * p8)));
    return safe_div(1.7724538 * num, den);
}

__device__ __forceinline__ double cpf12(double x, double xq, double abx,
                                        double y, double xlim4)
{
    constexpr double c[6] = {1.0117281, -0.75197147, 0.012557727,
                             0.010022008, -0.00024206814, 0.00000050084806};
    constexpr double s[6] = {1.393237, 0.23115241, -0.15535147,
                             0.0062183662, 0.000091908299,
                             -0.00000062752596};
    constexpr double tt[6] = {0.31424038, 0.94778839, 1.5976826,
                              2.2795071, 3.0206370, 3.8897249};
    const double ypy0 = y + 1.5;
    const double ypy0q = ypy0 * ypy0;
    const double y0q = 1.5 * 1.5;
    const double yf = y + 2.0 * 1.5;
    double buf1 = 0.0, buf2 = 0.0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
        const double dm = x - tt[j];
        const double mq = dm * dm;
        const double mf = 1.0 / (mq + ypy0q);
        const double xm = mf * dm;
        const double ym = mf * ypy0;
        const double dp = x + tt[j];
        const double pq = dp * dp;
        const double pf = 1.0 / (pq + ypy0q);
        const double xpl = pf * dp;
        const double yp = pf * ypy0;
        buf1 = buf1 + (c[j] * (ym + yp) - s[j] * (xm - xpl));
        buf2 = buf2 + ((c[j] * (mq * mf - 1.5 * ym) + (s[j] * yf) * xm)
                       / (mq + y0q)
                       + (c[j] * (pq * pf - 1.5 * yp) - (s[j] * yf) * xpl)
                       / (pq + y0q));
    }
    const double r2 = y * buf2 + exp(-xq);
    return abx <= xlim4 ? buf1 : r2;
}

// voigt_full where |x| < xlim0 and y < 70.55: its nested selection below
// the Lorentzian (regions 1, 2, 3, then CPF12), region_limits' other limits.
__device__ __noinline__ double voigt_core(double x, double y, double xlim0,
                                          double rsqrpi)
{
    const double yq = y * y;
    double xlim1 = y >= 8.425
        ? 0.0 : sqrt(fmax(164.0 - y * (4.3 + y * 1.8), 0.0));
    double xlim2 = 6.8 - y;
    const double xlim3 = 2.4 * y;
    const double xlim4 = 18.1 * y + 1.65;
    if (y <= 1.0e-6) {
        xlim1 = xlim0;
        xlim2 = xlim0;
    }
    const double abx = fabs(x);
    const double xq = abx * abx;
    if (abx >= xlim1) return region1(xq, y, yq, rsqrpi);
    if (abx >= xlim2) return region2(xq, y, yq, rsqrpi);
    if (abx < xlim3) return region3(xq, y);
    return cpf12(x, xq, abx, y, xlim4);
}

// Line j's term at grid point p: pref * K(x, y), x = (p - center) * srw.
__device__ __forceinline__ double line_term(double p, double center,
                                            double srw, double y, double pref,
                                            double rsqrpi)
{
    const double x = (p - center) * srw;
    double k = (y * rsqrpi) / (x * x + y * y);
    if (fabs(x) < kXlimBound && y < 70.55) {
        const double xlim0 = sqrt(fmax(15100.0 + y * (40.0 - y * 3.6), 0.0));
        if (fabs(x) < xlim0) k = voigt_core(x, y, xlim0, rsqrpi);
    }
    return pref * k;
}

// A gas's float64 line constants (ops/pedestal_cuda.py GasLines).
struct LineConsts {
    const double* nu;
    const double* delta_air;
    const double* gamma_air;
    const double* gamma_self;
    const double* n_air;
    const double* mass;
    const double* sw;
    const double* nu_c;
    const double* elower_c2;
    const double* neg_c2_nu;
    const double* one_minus_gref;
    const double* q_ref;
    const long long* slot;
};

// The physics' numbers: PA_TO_ATM, R2, SQRT_LN2, RSQRPI, the grid's v0
// and points a wavenumber, the cut-off, the rows' first bucket.
struct PhysConsts {
    double pa_to_atm, r2, sqrt_ln2, rsqrpi, v0, n_per_v, cut_off, b0;
};

// Kernel P: line_profile_params and kernel_inputs (models/lines/physics.py)
// of a (layer, line), in the plain version's float64 operations and order
// (ops/pedestal_cuda.py line_inputs: a divide by a number is an IEEE
// divide there too); exp, pow and sqrt are CUDA's, as torch's on the card.
__global__ void __launch_bounds__(kContribThreads)
pedestal_lines_kernel(LineConsts lc, const double* __restrict__ t,
                      const double* __restrict__ p,
                      const double* __restrict__ x,
                      const double* __restrict__ q_slots, int num,
                      int num_layers, PhysConsts k,
                      double* __restrict__ center, double* __restrict__ srw,
                      double* __restrict__ y, double* __restrict__ pref,
                      int* __restrict__ s_idx, int* __restrict__ e_idx,
                      int* __restrict__ bucket)
{
    const int i = blockIdx.x * kContribThreads + threadIdx.x;
    if (i >= num) return;
    const int l = blockIdx.y;
    const double tl = t[l];
    const double p_atm = p[l] * k.pa_to_atm;
    const double partial = p_atm * x[l];
    const double tfact = 296.0 / tl;
    const double nu_shift = lc.nu[i] + p_atm * lc.delta_air[i];
    const double gamma = (lc.gamma_air[i] * (p_atm - partial)
                          + lc.gamma_self[i] * partial)
        * pow(tfact, lc.n_air[i]);
    const double alpha = lc.nu_c[i] * sqrt(k.r2 * tl / lc.mass[i]);
    const double sb = exp(lc.elower_c2[i] * (tl - 296.0) / (tl * 296.0));
    const double se = (1.0 - exp(lc.neg_c2_nu[i] / tl))
        / lc.one_minus_gref[i];
    const double sq = lc.q_ref[i] / q_slots[lc.slot[i] * num_layers + l];
    const double sw = lc.sw[i] * sb * se * sq * 0.01 * 0.01;
    const double repwid = k.sqrt_ln2 / alpha;
    const double b = floor(nu_shift);
    const long long o = (long long)l * num + i;
    center[o] = (nu_shift - k.v0) * k.n_per_v;
    srw[o] = repwid / k.n_per_v;
    y[o] = repwid * gamma;
    pref[o] = sw * k.rsqrpi * repwid;
    s_idx[o] = (int)((b - k.cut_off - k.v0) * k.n_per_v);
    e_idx[o] = (int)((b + k.cut_off + 1.0 - k.v0) * k.n_per_v);
    bucket[o] = (int)(b - k.b0);
}

struct Lines {
    const double* center;
    const double* srw;
    const double* y;
    const double* pref;
    const int* s_idx;
    const int* e_idx;
    const int* bucket;

    __device__ __forceinline__ double term(double p, int j,
                                           double rsqrpi) const
    {
        return line_term(p, __ldg(center + j), __ldg(srw + j), __ldg(y + j),
                         __ldg(pref + j), rsqrpi);
    }

    __device__ __forceinline__ bool covers(int j, int p) const
    {
        return __ldg(s_idx + j) <= p && __ldg(e_idx + j) >= p;
    }
};

// The lines of bucket r lie in [seg_lo[r], seg_hi[r]) (the lines within
// the batch's largest shift of its wavenumber), and its window's clamped
// endpoints are p_s[r], p_e[r].
struct Buckets {
    const int* seg_lo;
    const int* seg_hi;
    const int* p_s;
    const int* p_e;
};

template <typename K>
__global__ void __launch_bounds__(kContribThreads)
pedestal_contrib_kernel(Lines ln, Buckets bk, const K* __restrict__ field,
                        long long field_b, long long field_off, int num,
                        int nb, int n, double rsqrpi,
                        double* __restrict__ ks_out,
                        double* __restrict__ pre_out,
                        double* __restrict__ c0_out,
                        double* __restrict__ cn_out)
{
    const int r = blockIdx.x * kContribThreads + threadIdx.x;
    if (r >= nb) return;
    const long long row = (long long)blockIdx.y * num;
    ln.center += row;
    ln.srw += row;
    ln.y += row;
    ln.pref += row;
    ln.s_idx += row;
    ln.e_idx += row;
    ln.bucket += row;
    ks_out += row;
    pre_out += row;
    c0_out += row;
    cn_out += row;
    const int lo = bk.seg_lo[r];
    const int hi = bk.seg_hi[r];
    const int ps = bk.p_s[r];
    const int pe = bk.p_e[r];
    // A covering line's window holds a grid point, so it is live.
    // Prefix at p_e: the lines [lo, i], added in line order from +0.0.
    double acc = 0.0;
    for (int j = lo; j < hi; ++j) {
        if (ln.covers(j, pe)) acc += ln.term((double)pe, j, rsqrpi);
        if (__ldg(ln.bucket + j) == r) pre_out[j] = acc;
    }
    // Suffix at p_s: the lines (i, hi), added from the last line down from
    // +0.0; each line of the bucket also takes its own edge terms.
    const double k_at = (double)field[blockIdx.y * field_b + field_off + ps];
    acc = 0.0;
    for (int j = hi - 1; j >= lo; --j) {
        if (__ldg(ln.bucket + j) == r) {
            ks_out[j] = k_at - acc;
            const int s = __ldg(ln.s_idx + j);
            const int e = __ldg(ln.e_idx + j);
            const bool live = s < n && e >= 0;
            c0_out[j] = live && s <= 0 && e >= 0
                ? ln.term(0.0, j, rsqrpi) : 0.0;
            cn_out[j] = live && s <= n - 1 && e >= n - 1
                ? ln.term((double)(n - 1), j, rsqrpi) : 0.0;
        }
        if (ln.covers(j, ps)) acc += ln.term((double)ps, j, rsqrpi);
    }
}

struct ScanRow {
    const int* bucket;
    const int* s_idx;
    const int* e_idx;
    const double* ks;
    const double* pre;
    const double* c0;
    const double* cn;
};

// a + b rounded once, opaque to the compiler, which would otherwise fold
// a select between two sums of a into one sum of a select (a longer chain).
__device__ __forceinline__ double add_rn(double a, double b)
{
    double r;
    asm("add.rn.f64 %0, %1, %2;" : "=d"(r) : "d"(a), "d"(b));
    return r;
}

__global__ void __launch_bounds__(kScanThreads)
pedestal_scan_kernel(ScanRow in, int num, int n, int window, int nb,
                     int in_smem, double* __restrict__ ped,
                     double* __restrict__ scratch)
{
    extern __shared__ double smem[];
    // Two staged tiles: [2][4][kScanTile] doubles (ks, pre, c0, cn), then
    // [2][4][kScanTile] ints (bucket, s, e, fast run), then, where they
    // fit, the bucket totals.
    constexpr int T = kScanTile;
    double* sd = smem;
    int* si = reinterpret_cast<int*>(smem + 2 * 4 * T);
    const long long row = (long long)blockIdx.x * num;
    double* bkt = in_smem ? reinterpret_cast<double*>(si + 2 * 4 * T)
                          : scratch + (long long)blockIdx.x * nb;
    for (int r = threadIdx.x; r < nb; r += kScanThreads) bkt[r] = 0.0;

    // Staging also marks the fast lines: a line whose window lies inside
    // the grid (s > 0, e < n - 1: live, unclamped, off both edge points)
    // after such a line of the same bucket.  At a fast line the scan's
    // left sum below the bucket is cached, its bucket's total is in a
    // register and no bucket but its own changes, so it takes the chain
    // alone.
    const auto stage = [&](int tile, int buf, int first, int stride) {
        const int lo = tile * T;
        const int cnt = min(T, num - lo);
        double* d = sd + buf * 4 * T;
        int* t = si + buf * 4 * T;
        for (int k = first; k < cnt; k += stride) {
            const long long g = row + lo + k;
            d[k] = in.ks[g];
            d[T + k] = in.pre[g];
            d[2 * T + k] = in.c0[g];
            d[3 * T + k] = in.cn[g];
            const int b = in.bucket[g];
            const int s = in.s_idx[g];
            const int e = in.e_idx[g];
            t[k] = b;
            t[T + k] = s;
            t[2 * T + k] = e;
            t[3 * T + k] = lo + k > 0 && s > 0 && e < n - 1
                && in.bucket[g - 1] == b && in.s_idx[g - 1] > 0
                && in.e_idx[g - 1] < n - 1;
        }
    };
    // Warp 1 then turns a staged tile's fast flags into run lengths: at
    // each line, the fast lines from it on (0 at a slow line), by ballots
    // over groups of 32 lines from the tile's end.
    const auto runs = [&](int buf, int cnt) {
        int* f = si + buf * 4 * T + 3 * T;
        const int lane = threadIdx.x & 31;
        int carry = 0;
        for (int g0 = ((cnt - 1) / 32) * 32; g0 >= 0; g0 -= 32) {
            const int k = g0 + lane;
            const unsigned mask = __ballot_sync(0xffffffffu, k < cnt && f[k]);
            const unsigned above = mask >> lane;
            const int ones = above == 0xffffffffu ? 32 : __ffs(~above) - 1;
            const int run = ones == 32 - lane ? ones + carry : ones;
            if (k < cnt) f[k] = run;
            carry = __shfl_sync(0xffffffffu, run, 0);
        }
    };
    const int tiles = (num + T - 1) / T;
    if (tiles > 0) stage(0, 0, threadIdx.x, kScanThreads);
    __syncthreads();
    if (tiles > 0 && threadIdx.x / 32 == 1) runs(0, min(T, num));
    __syncthreads();

    // The scan's state (thread 0): the edge sums; the cached left sum of
    // buckets [c_lo, c_b) and its validity; the highest bucket touched;
    // the last bucket updated with its total, which its slot holds only
    // after a slow line's flush; and the last window's top bucket.
    double p0_running = 0.0, pn_running = 0.0, cum0 = 0.0, cumn = 0.0;
    double c_val = 0.0, last_val = 0.0;
    int c_lo = 0, c_b = -1, tmax = -1, last_b = -1, e_top = -1;
    bool c_ok = false;

    const auto slow = [&](const double* d, const int* t, int k, long long g) {
        if (last_b >= 0) bkt[last_b] = last_val;
        const int s = t[T + k];
        const int e = t[2 * T + k];
        if (s >= n || e < 0) {
            ped[g] = 0.0;
            return;
        }
        // In range by the host's bound on the buckets; clamped so that no
        // input can write outside the row.
        const int b = min(max(t[k], 0), nb - 1);
        const bool cover0 = s <= 0 && e >= 0;
        const bool covern = s <= n - 1 && e >= n - 1;
        if (cover0) cum0 += d[2 * T + k];
        if (covern) cumn += d[3 * T + k];
        const double bb = bkt[b];
        double k_s, k_e;
        if (s < 0) {
            k_s = cum0 - p0_running;
        } else {
            const int wlo = max(b - window, 0);
            if (!c_ok || c_lo != wlo || c_b != b) {
                double acc = 0.0;
                for (int j = wlo; j < b; ++j) acc += bkt[j];
                c_val = acc;
                c_lo = wlo;
                c_b = b;
                c_ok = true;
            }
            k_s = d[k] - (c_val + bb);
        }
        if (e > n - 1) {
            k_e = cumn - pn_running;
        } else {
            const int top = min(min(b + window, nb - 1), tmax);
            double acc = bb;
            for (int j = b + 1; j <= top; ++j) acc += bkt[j];
            k_e = d[T + k] - acc;
        }
        const double value = k_s < k_e ? k_s : k_e;
        ped[g] = value;
        last_val = bb + value;
        bkt[b] = last_val;
        last_b = b;
        tmax = max(tmax, b);
        e_top = min(min(b + window, nb - 1), tmax);
        if (b >= c_lo && b < c_b) c_ok = false;
        if (cover0) p0_running += value;
        if (covern) pn_running += value;
    };

    for (int tile = 0; tile < tiles; ++tile) {
        const int buf = tile & 1;
        if (threadIdx.x >= 32) {
            if (tile + 1 < tiles) {
                stage(tile + 1, buf ^ 1, threadIdx.x - 32, kScanThreads - 32);
                // The staging warps alone (named barrier 1).
                asm volatile("bar.sync 1, %0;" :: "r"(kScanThreads - 32));
                if (threadIdx.x / 32 == 1)
                    runs(buf ^ 1, min(T, num - (tile + 1) * T));
            }
        } else if (threadIdx.x == 0) {
            const int lo = tile * T;
            const int cnt = min(T, num - lo);
            const double* d = sd + buf * 4 * T;
            const int* t = si + buf * 4 * T;
            int k = 0;
            while (k < cnt) {
                const int len = t[3 * T + k];
                if (len == 0) {
                    slow(d, t, k, row + lo + k);
                    ++k;
                    continue;
                }
                // A run of fast lines: the chain alone, both sums begun
                // beside the minimum's test.
                const double* ks = d + k;
                const double* pre = d + T + k;
                double* out = ped + row + lo + k;
                const double cv = c_val;
                double lv = last_val;
                if (e_top <= last_b) {
#pragma unroll 4
                    for (int j = 0; j < len; ++j) {
                        const double k_s = ks[j] - (cv + lv);
                        const double k_e = pre[j] - lv;
                        const bool lt = k_s < k_e;
                        out[j] = lt ? k_s : k_e;
                        lv = lt ? add_rn(lv, k_s) : add_rn(lv, k_e);
                    }
                } else {
                    for (int j = 0; j < len; ++j) {
                        double acc = lv;
                        for (int r = last_b + 1; r <= e_top; ++r)
                            acc += bkt[r];
                        const double k_s = ks[j] - (cv + lv);
                        const double k_e = pre[j] - acc;
                        const bool lt = k_s < k_e;
                        out[j] = lt ? k_s : k_e;
                        lv = lt ? add_rn(lv, k_s) : add_rn(lv, k_e);
                    }
                }
                last_val = lv;
                k += len;
            }
            if (last_b >= 0) bkt[last_b] = last_val;
        }
        __syncthreads();
    }
}

// Kernel D: the field's bucket totals, each bucket's pedestals in line
// order from +0.0, each first rounded to float32 where the field is
// float32 (as the host's remover and the JAX package's rounded them).
__global__ void __launch_bounds__(kContribThreads)
pedestal_totals_kernel(const double* __restrict__ ped,
                       const int* __restrict__ bucket, Buckets bk, int num,
                       int nb, int field_float, double* __restrict__ totals)
{
    const int r = blockIdx.x * kContribThreads + threadIdx.x;
    if (r >= nb) return;
    const long long row = (long long)blockIdx.y * num;
    double acc = 0.0;
    for (int j = bk.seg_lo[r]; j < bk.seg_hi[r]; ++j) {
        if (__ldg(bucket + row + j) != r) continue;
        const double v = __ldg(ped + row + j);
        acc += field_float ? (double)(float)v : v;
    }
    totals[(long long)blockIdx.y * nb + r] = acc;
}

template <typename K>
__global__ void __launch_bounds__(kFieldThreads)
pedestal_field_kernel(K* __restrict__ out, long long out_b,
                      long long out_off, const double* __restrict__ totals,
                      int nb, const int* __restrict__ blo,
                      const int* __restrict__ bhi, int b0, int n)
{
    const int p = blockIdx.x * kFieldThreads + threadIdx.x;
    if (p >= n) return;
    const double* t = totals + (long long)blockIdx.y * nb;
    const int lo = max(blo[p] - b0, 0);
    const int hi = min(bhi[p] - b0, nb - 1);
    double acc = 0.0;
    for (int r = lo; r <= hi; ++r) acc += __ldg(t + r);
    K* o = out + blockIdx.y * out_b + out_off + p;
    *o = *o - (K)acc;
}

}  // namespace

extern "C" {

// Kernel P over a gas's N lines and B layers: [B, N] outputs.
int pylbl_pedestal_lines(const double* nu, const double* delta_air,
                         const double* gamma_air, const double* gamma_self,
                         const double* n_air, const double* mass,
                         const double* sw, const double* nu_c,
                         const double* elower_c2, const double* neg_c2_nu,
                         const double* one_minus_gref, const double* q_ref,
                         const long long* slot, const double* t,
                         const double* p, const double* x,
                         const double* q_slots, int num_layers, int num,
                         double pa_to_atm, double r2, double sqrt_ln2,
                         double rsqrpi, double v0, double n_per_v,
                         double cut_off, double b0, double* center,
                         double* srw, double* y, double* pref, int* s_idx,
                         int* e_idx, int* bucket, void* stream)
{
    if (num > 0 && num_layers > 0) {
        const dim3 grid((num + kContribThreads - 1) / kContribThreads,
                        num_layers);
        const LineConsts lc{nu, delta_air, gamma_air, gamma_self, n_air,
                            mass, sw, nu_c, elower_c2, neg_c2_nu,
                            one_minus_gref, q_ref, slot};
        const PhysConsts k{pa_to_atm, r2, sqrt_ln2, rsqrpi, v0, n_per_v,
                           cut_off, b0};
        pedestal_lines_kernel<<<grid, kContribThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
            lc, t, p, x, q_slots, num, num_layers, k, center, srw, y, pref,
            s_idx, e_idx, bucket);
    }
    return (int)cudaGetLastError();
}

// Kernel A over a gas's [B, N] lines (rows of N, contiguous), a thread a
// (layer, bucket) of nb; the field [B, ...] is float32 (field_double 0) or
// float64, the gas's points from field_off in each layer's row of field_b
// elements.
int pylbl_pedestal_contrib(const double* center, const double* srw,
                           const double* y, const double* pref,
                           const int* s_idx, const int* e_idx,
                           const int* bucket, const int* seg_lo,
                           const int* seg_hi, const int* p_s, const int* p_e,
                           const void* field, int field_double,
                           long long field_b, long long field_off,
                           int num_layers, int num, int nb, int n,
                           double rsqrpi, double* ks, double* pre,
                           double* c0, double* cn, void* stream)
{
    if (n <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
    if (num > 0 && num_layers > 0) {
        const dim3 grid((nb + kContribThreads - 1) / kContribThreads,
                        num_layers);
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        const Lines ln{center, srw, y, pref, s_idx, e_idx, bucket};
        const Buckets bk{seg_lo, seg_hi, p_s, p_e};
        if (field_double) {
            pedestal_contrib_kernel<double><<<grid, kContribThreads, 0, s>>>(
                ln, bk, static_cast<const double*>(field), field_b,
                field_off, num, nb, n, rsqrpi, ks, pre, c0, cn);
        } else {
            pedestal_contrib_kernel<float><<<grid, kContribThreads, 0, s>>>(
                ln, bk, static_cast<const float*>(field), field_b,
                field_off, num, nb, n, rsqrpi, ks, pre, c0, cn);
        }
    }
    return (int)cudaGetLastError();
}

// Kernel B over num_rows rows of num lines: each line's pedestal; scratch
// [rows, nb] holds the bucket totals where shared memory cannot.
int pylbl_pedestal_scan(const int* bucket, const int* s_idx, const int* e_idx,
                        const double* ks, const double* pre, const double* c0,
                        const double* cn, int num_rows, int num, int n,
                        int window, int nb, double* ped, double* scratch,
                        void* stream)
{
    if (n <= 0 || nb <= 0 || window < 0) return (int)cudaErrorInvalidValue;
    if (num_rows <= 0) return (int)cudaGetLastError();
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const size_t with_buckets = kScanStage + (size_t)nb * sizeof(double);
    const int in_smem = with_buckets <= (size_t)optin ? 1 : 0;
    const size_t smem = in_smem ? with_buckets : kScanStage;
    err = cudaFuncSetAttribute(pedestal_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const ScanRow in{bucket, s_idx, e_idx, ks, pre, c0, cn};
    pedestal_scan_kernel<<<num_rows, kScanThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        in, num, n, window, nb, in_smem, ped, scratch);
    return (int)cudaGetLastError();
}

// Kernel D: totals [B, nb] of the pedestals ped [B, N] by bucket.
int pylbl_pedestal_totals(const double* ped, const int* bucket,
                          const int* seg_lo, const int* seg_hi,
                          int num_layers, int num, int nb, int field_float,
                          double* totals, void* stream)
{
    if (nb <= 0) return (int)cudaErrorInvalidValue;
    if (num_layers > 0) {
        const dim3 grid((nb + kContribThreads - 1) / kContribThreads,
                        num_layers);
        const Buckets bk{seg_lo, seg_hi, nullptr, nullptr};
        pedestal_totals_kernel<<<grid, kContribThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
            ped, bucket, bk, num, nb, field_float, totals);
    }
    return (int)cudaGetLastError();
}

// Kernel C: out[l, out_off + p] -= the sum of totals[l, r] over r in
// [blo[p] - b0, bhi[p] - b0] within [0, nb), for p < n; out float32
// (out_double 0) or float64, rows of out_b elements.
int pylbl_pedestal_field(void* out, int out_double, long long out_b,
                         long long out_off, const double* totals, int nb,
                         const int* blo, const int* bhi, int b0,
                         int num_layers, int n, void* stream)
{
    if (nb <= 0) return (int)cudaErrorInvalidValue;
    if (n > 0 && num_layers > 0) {
        const dim3 grid((n + kFieldThreads - 1) / kFieldThreads, num_layers);
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (out_double) {
            pedestal_field_kernel<double><<<grid, kFieldThreads, 0, s>>>(
                static_cast<double*>(out), out_b, out_off, totals, nb, blo,
                bhi, b0, n);
        } else {
            pedestal_field_kernel<float><<<grid, kFieldThreads, 0, s>>>(
                static_cast<float*>(out), out_b, out_off, totals, nb, blo,
                bhi, b0, n);
        }
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
