// Hand-written Hopper kernels for the stacked line-by-line absorption path.
//
// Built by pylbl_tpu_torch/ops/lineshape_cuda.py (runtime/build.py) with
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a -fmad=false
//        -shared -Xcompiler -fPIC
// into a plain C library bound with ctypes.  No --use_fast_math: the wings
// divide and the Humlicek rationals, exp and sqrt stay IEEE, and
// -fmad=false keeps every a*b+c as two rounded operations, so the kernels
// produce the values of the plain PyTorch versions beside their wrappers.
//
// pylbl_wings: strided prepacked wings with an optional tail chunk class
//   (replaces _tile_kernel_strided_pre_tail_batched and, with no tail,
//   _tile_kernel_strided_pre_batched in pylbl_tpu/ops/lineshape_pallas.py)
//   and, with stride == tile, the splat wings (_tile_kernel_batched with
//   _lorentz_line_pre).  One block per (tile, layer); 256 threads each own
//   tile/256 output points; each chunk of the 8-row SoA is staged in shared
//   memory and its lines are walked in order into a per-chunk partial that
//   then lands in the tile accumulator (two-level summation).  The work is
//   one IEEE f32 divide per line-point: the kernel is bound by the divide
//   sequence, and reads every line once per tile as a shared-memory
//   broadcast.
//
// pylbl_core_segmix: mixed-slot segment-32 Humlicek core correction
//   (replaces _seg_kernel_mixed_batched with _seg_chunk_accumulate_mixed).
//   One block of 4 warps per (tile, layer).  Per 128-instance chunk: stage
//   the 8 parameter rows, reduce min y, pick the correction class once for
//   the chunk (block-uniform branch), then warp w walks instances
//   32w..32w+31 in order with lane = point offset in the 32-point segment,
//   adding pref * (K_class - K_lorentz) into its private [slot][offset]
//   partial tile in shared memory.  The four partials are summed in warp
//   order into the tile accumulator.  Direct indexed adds replace the TPU's
//   one-hot matrix product: no tensor cores (TF32 would round the values),
//   no atomics (runs are bit-identical).  Bound by the Humlicek math.
//
// Each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#define F(x) ((float)(x))

constexpr int kWingsThreads = 256;
constexpr int kMaxChunk = 512;
constexpr int kCoreThreads = 128;
constexpr int kMaxTile = 1024;

// SoA rows (lineshape_pallas.py C_INT..E_IDX; Y holds y^2 and PREF holds
// pref*y/sqrt(pi) in the prepacked layout).
constexpr int kCInt = 0, kCFrac = 1, kSrw = 2, kY = 3, kPref = 4,
              kSIdx = 5, kEIdx = 6;
// Core parameter rows (SR_SEG0REL..SR_SLOT).
constexpr int kSeg0Rel = 0, kCoreCFrac = 1, kCoreSrw = 2, kCoreY = 3,
              kCorePref = 4, kSRel = 5, kERel = 6, kSlot = 7;

template <int PPT>
__global__ void __launch_bounds__(kWingsThreads)
wings_kernel(const float* __restrict__ soa, long long soa_b, long long soa_r,
             const int* __restrict__ w_start, const int* __restrict__ w_n,
             const int* __restrict__ t_start, const int* __restrict__ t_n,
             long long csr_b, float* __restrict__ out, int num_tiles,
             int tile, int stride, int chunk, int tail)
{
    __shared__ float buf[7][kMaxChunk];
    const int t = blockIdx.x;
    const int b = blockIdx.y;
    const float* lines = soa + b * soa_b;
    const long long csr = b * csr_b + t;

    float point[PPT], acc[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
        point[j] = (float)(t * stride + threadIdx.x + j * kWingsThreads);
        acc[j] = 0.0f;
    }
    for (int cls = 0; cls < 2; ++cls) {
        int base, count, width;
        if (cls == 0) {
            base = w_start[csr];
            count = w_n[csr];
            width = chunk;
        } else {
            if (t_start == nullptr) break;
            base = t_start[csr];
            count = t_n[csr];
            width = tail;
        }
        for (int k = 0; k < count; ++k) {
            const long long line0 = (long long)base + (long long)k * width;
            __syncthreads();
            for (int i = threadIdx.x; i < 7 * width; i += kWingsThreads) {
                const int r = i / width;
                const int l = i - r * width;
                buf[r][l] = lines[r * soa_r + line0 + l];
            }
            __syncthreads();
            float part[PPT];
#pragma unroll
            for (int j = 0; j < PPT; ++j) part[j] = 0.0f;
            for (int l = 0; l < width; ++l) {
                const float c_int = buf[kCInt][l];
                const float c_frac = buf[kCFrac][l];
                const float srw = buf[kSrw][l];
                const float ysq = buf[kY][l];
                const float pref_y = buf[kPref][l];
                const float s = buf[kSIdx][l];
                const float e = buf[kEIdx][l];
#pragma unroll
                for (int j = 0; j < PPT; ++j) {
                    const float x = ((point[j] - c_int) - c_frac) * srw;
                    const float val = pref_y / (x * x + ysq);
                    const bool in = (point[j] >= s) && (point[j] <= e);
                    part[j] = part[j] + (in ? val : 0.0f);
                }
            }
#pragma unroll
            for (int j = 0; j < PPT; ++j) acc[j] = acc[j] + part[j];
        }
    }
    float* o = out + ((long long)b * num_tiles + t) * tile;
#pragma unroll
    for (int j = 0; j < PPT; ++j) o[threadIdx.x + j * kWingsThreads] = acc[j];
}

// ---- Humlicek classes (pylbl_tpu_torch/ops/voigt.py, same op order) ----

constexpr double kRsqrpi = 0.56418958354775628695;  // 1/sqrt(pi)

__device__ __forceinline__ float safe_div(float num, float den)
{
    return num / (den == 0.0f ? 1.0f : den);
}

__device__ __forceinline__ float lorentz(float x, float y)
{
    return (y * F(kRsqrpi)) / (x * x + y * y);
}

__device__ __forceinline__ float region1(float xq, float y, float yq)
{
    const float a0 = yq + F(0.5);
    const float d0 = a0 * a0;
    const float d2 = (yq + yq) - F(1.0);
    const float den = d0 + xq * (d2 + xq);
    return safe_div((F(kRsqrpi) * y) * (a0 + xq), den);
}

__device__ __forceinline__ float region2(float xq, float y, float yq)
{
    const float h0 = F(0.5625) + yq * (F(4.5) + yq * (F(10.5) + yq * (F(6.0)
                     + yq)));
    const float h2 = F(-4.5) + yq * (F(9.0) + yq * (F(6.0) + yq * F(4.0)));
    const float h4 = F(10.5) - yq * (F(6.0) - yq * F(6.0));
    const float h6 = F(-6.0) + yq * F(4.0);
    const float e0 = F(1.875) + yq * (F(8.25) + yq * (F(5.5) + yq));
    const float e2 = F(5.25) + yq * (F(1.0) + yq * F(3.0));
    const float e4 = F(0.75) * h6;
    const float den = h0 + xq * (h2 + xq * (h4 + xq * (h6 + xq)));
    return safe_div((y * (e0 + xq * (e2 + xq * (e4 + xq)))) * F(kRsqrpi),
                    den);
}

__device__ __forceinline__ float region3(float xq, float y)
{
    const float z0 = F(272.1014) + y * (F(1280.829) + y * (F(2802.870)
        + y * (F(3764.966) + y * (F(3447.629) + y * (F(2256.981)
        + y * (F(1074.409) + y * (F(369.1989) + y * (F(88.26741)
        + y * (F(13.39880) + y)))))))));
    const float z2 = F(211.678) + y * (F(902.3066) + y * (F(1758.336)
        + y * (F(2037.310) + y * (F(1549.675) + y * (F(793.4273)
        + y * (F(266.2987) + y * (F(53.59518) + y * F(5.0))))))));
    const float z4 = F(78.86585) + y * (F(308.1852) + y * (F(497.3014)
        + y * (F(479.2576) + y * (F(269.2916) + y * (F(80.39278)
        + y * F(10.0))))));
    const float z6 = F(22.03523) + y * (F(55.02933) + y * (F(92.75679)
        + y * (F(53.59518) + y * F(10.0))));
    const float z8 = F(1.496460) + y * (F(13.39880) + y * F(5.0));
    const float p0 = F(153.5168) + y * (F(549.3954) + y * (F(919.4955)
        + y * (F(946.8970) + y * (F(662.8097) + y * (F(328.2151)
        + y * (F(115.3772) + y * (F(27.93941) + y * (F(4.264678)
        + y * F(0.3183291)))))))));
    const float p2 = F(-34.16955) + y * (F(-1.322256) + y * (F(124.5975)
        + y * (F(189.7730) + y * (F(139.4665) + y * (F(56.81652)
        + y * (F(12.79458) + y * F(1.2733163)))))));
    const float p4 = F(2.584042) + y * (F(10.46332) + y * (F(24.01655)
        + y * (F(29.81482) + y * (F(12.79568) + y * F(1.9099744)))));
    const float p6 = F(-0.07272979) + y * (F(0.9377051) + y * (F(4.266322)
        + y * F(1.273316)));
    const float p8 = F(0.0005480304) + y * F(0.3183291);
    const float den = z0 + xq * (z2 + xq * (z4 + xq * (z6 + xq * (z8
        + xq))));
    const float num = p0 + xq * (p2 + xq * (p4 + xq * (p6 + xq * p8)));
    return safe_div(F(1.7724538) * num, den);
}

__device__ __forceinline__ float cpf12(float x, float xq, float abx,
                                       float y, float xlim4)
{
    constexpr double c[6] = {1.0117281, -0.75197147, 0.012557727,
                             0.010022008, -0.00024206814, 0.00000050084806};
    constexpr double s[6] = {1.393237, 0.23115241, -0.15535147,
                             0.0062183662, 0.000091908299,
                             -0.00000062752596};
    constexpr double tt[6] = {0.31424038, 0.94778839, 1.5976826,
                              2.2795071, 3.0206370, 3.8897249};
    const float ypy0 = y + F(1.5);
    const float ypy0q = ypy0 * ypy0;
    const float y0q = F(1.5 * 1.5);
    const float yf = y + F(2.0 * 1.5);
    float buf1 = 0.0f, buf2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
        const float cj = F(c[j]), sj = F(s[j]), tj = F(tt[j]);
        const float dm = x - tj;
        const float mq = dm * dm;
        const float mf = F(1.0) / (mq + ypy0q);
        const float xm = mf * dm;
        const float ym = mf * ypy0;
        const float dp = x + tj;
        const float pq = dp * dp;
        const float pf = F(1.0) / (pq + ypy0q);
        const float xpl = pf * dp;
        const float yp = pf * ypy0;
        buf1 = buf1 + (cj * (ym + yp) - sj * (xm - xpl));
        buf2 = buf2 + ((cj * (mq * mf - F(1.5) * ym) + (sj * yf) * xm)
                       / (mq + y0q)
                       + (cj * (pq * pf - F(1.5) * yp) - (sj * yf) * xpl)
                       / (pq + y0q));
    }
    const float r2 = y * buf2 + expf(-xq);
    return abx <= xlim4 ? buf1 : r2;
}

struct Limits {
    float xlim0, xlim1, xlim2, xlim3, xlim4, yq;
};

__device__ __forceinline__ Limits region_limits(float y)
{
    Limits l;
    l.yq = y * y;
    l.xlim0 = sqrtf(fmaxf(F(15100.0) + y * (F(40.0) - y * F(3.6)), 0.0f));
    l.xlim1 = y >= F(8.425)
        ? 0.0f
        : sqrtf(fmaxf(F(164.0) - y * (F(4.3) + y * F(1.8)), 0.0f));
    l.xlim2 = F(6.8) - y;
    l.xlim3 = F(2.4) * y;
    l.xlim4 = F(18.1) * y + F(1.65);
    const bool tiny = y <= F(1.0e-6);
    if (tiny) {
        l.xlim1 = l.xlim0;
        l.xlim2 = l.xlim0;
    }
    return l;
}

// voigt_correction_k1: y >= 8.425, one combined rational.
__device__ __forceinline__ float corr_k1(float x, float y)
{
    const float xq = x * x;
    const float yq = y * y;
    const float xlim0q = fmaxf(F(15100.0) + y * (F(40.0) - y * F(3.6)),
                               0.0f);
    const float a0 = yq + F(0.5);
    const float d0 = a0 * a0;
    const float d2 = (yq + yq) - F(1.0);
    const float num = (y * F(kRsqrpi)) * (F(1.5) * xq - (F(0.5) * yq
                                                         + F(0.25)));
    const float den = (d0 + xq * (d2 + xq)) * (xq + yq);
    const bool needs = (xq < xlim0q) && (y < F(70.55));
    return needs ? num / den : 0.0f;
}

// voigt_correction_k12 (regions 1-2), _k123 (regions 1-3) and the full
// form (regions 1-3 + CPF12), selected per point in reference order.
template <int CLASS>
__device__ __forceinline__ float corr_regions(float x, float y)
{
    const Limits l = region_limits(y);
    const float abx = fabsf(x);
    const float xq = abx * abx;
    const bool needs = (abx < l.xlim0) && (y < F(70.55));
    if (!needs) return 0.0f;
    float inner;
    if (abx >= l.xlim1) {
        inner = region1(xq, y, l.yq);
    } else if (CLASS == 2 || abx >= l.xlim2) {
        inner = region2(xq, y, l.yq);
    } else if (CLASS == 3 || abx < l.xlim3) {
        inner = region3(xq, y);
    } else {
        inner = cpf12(x, xq, abx, y, l.xlim4);
    }
    return inner - lorentz(x, y);
}

template <int CLASS>
__device__ __forceinline__ float correction(float x, float y)
{
    if (CLASS == 1) return corr_k1(x, y);
    return corr_regions<CLASS>(x, y);
}

template <int CLASS>
__device__ __forceinline__ void core_chunk(const float (*prm)[kCoreThreads],
                                           float* part, int warp, int lane)
{
    const float o = (float)lane;
    for (int j = 0; j < 32; ++j) {
        const int i = warp * 32 + j;
        const float x = ((prm[kSeg0Rel][i] + o) - prm[kCoreCFrac][i])
                        * prm[kCoreSrw][i];
        const float val = correction<CLASS>(x, prm[kCoreY][i]);
        const bool in = (o >= prm[kSRel][i]) && (o <= prm[kERel][i]);
        const int slot = (int)prm[kSlot][i];
        float* cell = part + slot * 32 + lane;
        *cell = *cell + (in ? prm[kCorePref][i] * val : 0.0f);
    }
}

__global__ void __launch_bounds__(kCoreThreads)
core_segmix_kernel(const float* __restrict__ params, long long p_b,
                   long long p_r, const int* __restrict__ tile_start,
                   const int* __restrict__ tile_chunks,
                   float* __restrict__ out, int num_tiles, int tile)
{
    __shared__ float prm[8][kCoreThreads];
    __shared__ float part[kCoreThreads / 32][kMaxTile];
    __shared__ float acc[kMaxTile];
    __shared__ float wmin[kCoreThreads / 32];
    const int t = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const float* p = params + b * p_b;

    for (int c = tid; c < tile; c += kCoreThreads) {
        acc[c] = 0.0f;
#pragma unroll
        for (int w = 0; w < kCoreThreads / 32; ++w) part[w][c] = 0.0f;
    }
    const int first = tile_start[t];
    const int count = tile_chunks[t];
    for (int k = 0; k < count; ++k) {
        const long long col = (long long)(first + k) * kCoreThreads + tid;
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 8; ++r) prm[r][tid] = p[r * p_r + col];
        float m = prm[kCoreY][tid];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) wmin[warp] = m;
        __syncthreads();
        const float ymin = fminf(fminf(wmin[0], wmin[1]),
                                 fminf(wmin[2], wmin[3]));
        if (ymin >= F(70.55)) continue;   // pure Lorentz chunk: no-op
        float* mine = part[warp];
        if (ymin >= F(8.425)) {
            core_chunk<1>(prm, mine, warp, lane);
        } else if (ymin >= F(6.8)) {
            core_chunk<2>(prm, mine, warp, lane);
        } else if (ymin >= F(2.0)) {
            core_chunk<3>(prm, mine, warp, lane);
        } else {
            core_chunk<4>(prm, mine, warp, lane);
        }
        __syncthreads();
        for (int c = tid; c < tile; c += kCoreThreads) {
            const float sum = ((part[0][c] + part[1][c]) + part[2][c])
                              + part[3][c];
            acc[c] = acc[c] + sum;
#pragma unroll
            for (int w = 0; w < kCoreThreads / 32; ++w) part[w][c] = 0.0f;
        }
    }
    __syncthreads();
    float* o = out + ((long long)b * num_tiles + t) * tile;
    for (int c = tid; c < tile; c += kCoreThreads) o[c] = acc[c];
}

}  // namespace

extern "C" {

int pylbl_wings(const float* soa, long long soa_b, long long soa_r,
                const int* w_start, const int* w_n, const int* t_start,
                const int* t_n, long long csr_b, float* out, int num_layers,
                int num_tiles, int tile, int stride, int chunk, int tail,
                void* stream)
{
    const dim3 grid(num_tiles, num_layers);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (num_tiles > 0 && num_layers > 0) {
        switch (tile / kWingsThreads) {
        case 1:
            wings_kernel<1><<<grid, kWingsThreads, 0, s>>>(
                soa, soa_b, soa_r, w_start, w_n, t_start, t_n, csr_b, out,
                num_tiles, tile, stride, chunk, tail);
            break;
        case 2:
            wings_kernel<2><<<grid, kWingsThreads, 0, s>>>(
                soa, soa_b, soa_r, w_start, w_n, t_start, t_n, csr_b, out,
                num_tiles, tile, stride, chunk, tail);
            break;
        case 4:
            wings_kernel<4><<<grid, kWingsThreads, 0, s>>>(
                soa, soa_b, soa_r, w_start, w_n, t_start, t_n, csr_b, out,
                num_tiles, tile, stride, chunk, tail);
            break;
        default:
            return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}

int pylbl_core_segmix(const float* params, long long p_b, long long p_r,
                      const int* tile_start, const int* tile_chunks,
                      float* out, int num_layers, int num_tiles, int tile,
                      int chunk, int seg, void* stream)
{
    if (chunk != kCoreThreads || seg != 32 || tile > kMaxTile)
        return (int)cudaErrorInvalidValue;
    if (num_tiles > 0 && num_layers > 0) {
        const dim3 grid(num_tiles, num_layers);
        core_segmix_kernel<<<grid, kCoreThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
            params, p_b, p_r, tile_start, tile_chunks, out, num_tiles, tile);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
