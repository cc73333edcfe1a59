// Hand-written Hopper kernels for the line-by-line absorption paths.
//
// Built by pylbl_tpu_torch/ops/lineshape_cuda.py (runtime/build.py) with
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a -fmad=false
//        -shared -Xcompiler -fPIC
// into a plain C library bound with ctypes.  No --use_fast_math: the wings
// divide and the Humlicek rationals, exp and sqrt stay IEEE, and
// -fmad=false keeps every a*b+c as two rounded operations, so the kernels
// produce the values of the plain PyTorch versions beside their wrappers.
//
// pylbl_wings: the tile kernel, by line function.
//   PRE (prepacked Lorentzian, Y row = y^2, PREF row = pref*y/sqrt(pi)):
//   strided wings with an optional tail chunk class (replaces
//   _tile_kernel_strided_pre_tail(_batched) and, with no tail,
//   _tile_kernel_strided_pre(_batched) in pylbl_tpu/ops/lineshape_pallas.py)
//   and, with stride == tile, the splat wings (_tile_kernel(_batched) with
//   _lorentz_line_pre).  RAW (_lorentz_line: ((pref*y)/sqrt(pi)) /
//   (x^2 + y^2) from the raw rows) serves _tile_kernel(_batched) with
//   stride == tile: the single-layer splat of Gas where no stride fits and
//   the batched splat under core_mode "seg"/"rows" or wings_mode "tile".
//   OWN is RAW with the line's strength zeroed unless its _PAD row equals
//   the tile index as float32: the ownership-checked strided wings over a
//   straddle CSR, where neighbouring tiles read shared chunks (replaces
//   _tile_kernel_strided(_batched)).  CORR (_correction_line: the per-line
//   Humlicek correction, class picked from the line's own y, lines with
//   y >= 70.55 skipped) serves _tile_kernel(_batched) with stride == tile.
//   A single layer is a batch of one.
//   The work is the in-window line-points, each one Lorentzian term: 7
//   operations, one of them a reciprocal.  So the kernel is bound by
//   instruction issue, not memory (the line block is read once a tile):
//   every instruction spent on a line rather than on a term, every masked
//   term, and every stall of a term's dependent chain is time; the MUFU's
//   16 reciprocals a clock per SM floor it.  A tile's chunk count is very
//   uneven (up to ~70 chunks against a mean of ~12 on the headline
//   layer), so the tile's chunk walk (main chunks, then tail chunks) is
//   cut into pieces of at most K chunks (the host's piece list,
//   ops/lineshape_cuda.py TilePieces), one block per (piece, layer); the
//   pieces fold into the tile in piece order (piece_fold).
//   PRE, RAW and OWN take the Lorentzian walk (lorentz_walk_kernel<PPT,
//   LINE>): tile / kWalkPoints threads, warp w owning the tile's
//   32 * kWalkPoints consecutive points from w * 32 * kWalkPoints (lane l
//   the points 32j + l of them), compiled for kWalkBlocks blocks an SM (32
//   registers, 64 warps: the terms' dependent chains need the warps, and
//   one chunk a piece gives the blocks).  Chunk k + 1 is copied with 4-byte
//   cp.async into a 2-slot ring while chunk k is walked (one slot when a
//   piece is one chunk); the ring holds the chunk line major (walk_slot),
//   so a line's fields reach a warp as two 16-byte broadcasts, not seven
//   4-byte ones.  Per 32 lines of the chunk each lane tests one line's
//   window against its warp's points, and two ballots give the warp the
//   lines whose window reaches its points and those whose window holds them
//   all; the warp walks the set bits in line order.  A line that misses the
//   warp's points is never loaded (it would add +0.0 to every point, and a
//   sum that starts at +0.0 never holds -0.0, so skipping it leaves the
//   bits unchanged); a line whose window holds the warp's points takes the
//   body without the window mask (every term is in window); only a line
//   whose window edge falls inside the warp's points keeps the per-group
//   test and the mask.  The term is pref_y * rcp(x^2 + y^2), an IEEE
//   reciprocal and an IEEE multiply (lorentz_term): div.rn.f32's range
//   check and slow-path branch around each divide cost more than the
//   second rounding, which the plain version repeats.  Each point's sum is
//   the same chain as before: per chunk a partial over its lines in line
//   order from +0.0, added into the piece accumulator in walk order.  The
//   splat's chunk padding (lines rounding each tile's walk up to whole
//   chunks) has empty windows and costs one test per lane per 32 lines.
//   RAW and OWN stage the raw rows (OWN also _PAD, in the slot's free
//   eighth float); a block pass over each landed slot (one more barrier a
//   chunk) rewrites each line's y and pref into the prepacked y^2 and
//   pref*y/sqrt(pi), in the plain version's float32 order (raw_line).
//   Forming them in registers at every line visit instead was 2-4%
//   slower on the card (PERF.md).  The same pass leaves out, before the
//   ballot, a line OWN's tile does not own where every term of it is
//   provably +/-0.0 (own_drops: y^2 finite and normal, x never NaN) by
//   emptying its window; a foreign line that could give NaN (y = 0 at
//   x = 0, a non-finite y or x) stays in the walk at strength 0 and gives
//   the plain version's NaN.
//   CORR (corr_walk_kernel<G>) takes the unit walk (below) with the
//   Lorentzian walk's ring: tile / (32 G) warps, the chunk's lines the
//   items.  Its windows are the lines' wing windows (the CSR lists the
//   tiles that a line's core window meets), of which 1.5% of the points
//   need a correction on the headline layer (tools/core_census.py): the
//   need window skips the rest.  A chunk's 512 lines lie within about a
//   hundred points there, so the block, not the warp that owns those
//   points, works them, and warp w sums the tile's point groups w,
//   w + warps, ...
//
// pylbl_seg: the per-stream segment-32 pass (replaces _seg_kernel and
//   _seg_kernel_batched).  Every 128-instance chunk carries ONE segment
//   slot, so it adds to one (tile, slot) stream of 32 points, and a
//   stream's chunks are folded in walk order.  One block per (tile, layer)
//   would walk a tile's chunks in series (up to 4,359 chunks on the
//   headline layer's wings), so the pass is two launches over the
//   stream-ordered chunk list: a chunk kernel writes each (entry, layer)'s
//   32-point chunk sum to a scratch [B, E, 32], in the one order there is
//   (warp partial w over instances 32w..32w+31 in order from +0.0, then
//   ((w0 + w1) + w2) + w3), and seg_fold_kernel gives each output point
//   one thread that adds its stream's chunk sums in walk order from +0.0
//   (a stream of no chunks writes +0.0).  A skipped term is +/-0.0, and a
//   sum that starts at +0.0 never holds -0.0, so skipping leaves the bits
//   of every term added.  No float atomics: runs are bit-identical.
//   CORE (seg_core_kernel; _seg_chunk_accumulate): the chunk sum is what
//   the mixed-slot core computes for one slot (the segment block's slot
//   row is all zeros, and core_sum adds each warp group's live instances
//   of a slot in order from +0.0, then ((g0 + g1) + g2) + g3), and most
//   in-window points need no correction while those that do diverge
//   across the Humlicek regions: so a block of 4 warps walks K entries
//   (the next staged by TMA bulk copies while one is worked) and runs the
//   mixed-slot core's phases on each (core_chunk, the one copy of them;
//   the class from the chunk's min y), then sums slot 0's four warp
//   groups in parallel.  Bound: the
//   Humlicek rationals of the points that need a correction.  WINGS
//   (seg_wings_kernel; _seg_chunk_accumulate_lorentz): lane = offset of
//   the absolute points 32 * stream + o, the term the IEEE quotient
//   ((pref*y)/sqrt(pi)) / (x^2 + y^2) of the plain version (a reciprocal
//   times the numerator would round twice).  Each warp walks its entry on
//   its own: the 7 rows staged with 16-byte cp.async, then per group of
//   32 instances each lane rewrites its instance line-major (walk_slot: a
//   term reads an instance as two 16-byte broadcasts) with y^2,
//   pref*y/sqrt(pi) and the lanes its window holds (a bit mask: the
//   window test of a term is an AND and a select), and a ballot lists the
//   instances that reach the segment, so that a missing instance is never
//   loaded; a group that all reach takes its 32 terms unrolled.  Bound:
//   about 20 warp instructions a term, ten of them the IEEE divide, beside
//   the bytes of the 7 rows read (PERF.md has what holds it above both).
//
// pylbl_core_segmix: mixed-slot segment-32 Humlicek core correction
//   (replaces _seg_kernel_mixed(_batched) with _seg_chunk_accumulate_mixed;
//   a single layer is a batch of one).  Every (instance, offset) of a
//   128-instance chunk's [instance, 32-point segment] block is in the
//   walk, but on the main path only 15-50% of the in-window points need a
//   correction (|x| < xlim0; the rest are +0.0), and those that do take
//   one of the Humlicek regions by their own |x|, CPF12 about ten times
//   the work of region 1.  Lane = offset ran every point and diverged
//   across the regions, so the kernel was bound by instruction issue on
//   work it threw away.  The design, one block of 4 warps per (piece of
//   at most K chunks, layer), the chunks' 8 parameter rows staged with
//   cp.async into a 2-slot ring; per chunk (class from its min y, NaN
//   where a y is, as the plain version's amin; block-uniform; skip at >=
//   70.55; a NaN min y takes class 4, as it fails every test of the JAX
//   conds; phases 1-3 are core_chunk, which the segment core runs
//   too): (1) classify, lane = instance, the
//   one phase compiled per class: the y-only limits once, then each window
//   offset's x and its list (K1, or region 1, 2, 3, CPF12), the offsets
//   that need nothing left out (core_needs); (2) list the needed pairs by
//   a block scan, each list padded to whole rounds of 32 (core_lists);
//   (3) evaluate the lists 32 pairs a round, one region body a warp, into
//   a zeroed [instance][offset] value block in shared memory, by one copy
//   of each region's code, the code correction<CLASS> runs (core_eval);
//   (4) sum in the one-block walk's order: warp w owns slots w, w+4, ...,
//   and per slot adds each warp group's live instances in order from
//   +0.0, then ((g0 + g1) + g2) + g3 into its registers' piece accumulator
//   (core_sum).  A skipped term is +/-0.0 and a sum that starts at +0.0
//   never holds -0.0, so the bits are those of every term added; an
//   offset whose sum went non-finite in one slot is NaN in the tile's
//   other slots, as the one-hot product's 0 * inf (core_spread); the
//   pieces fold into the tile in piece order (piece_fold).  The kernel is
//   bound by instruction issue and its barriers: more code (a phase
//   compiled per class, two entries a lane, unrolled or regrouped sums)
//   was slower on the card, and so were one and two chunks a piece on the
//   larger walks (PERF.md).  Direct indexed adds replace the
//   TPU's one-hot matrix product: no tensor cores (TF32 would round the
//   values), no float atomics (runs are bit-identical).

// Piece split (pylbl_wings, pylbl_core_segmix, pylbl_rows): piece j of
//   tile t walks units jK .. min(jK + K, count) - 1 of the tile's walk
//   (chunks; groups for the rows core).  A tile of one
//   piece writes its sum directly.  A split tile's pieces each write their
//   partial tile to a scratch slot, fence, and count themselves on the
//   tile's integer counter; the block that counts last adds the slots in
//   piece order, ((0 + P0) + P1) + ..., into the output.  The order is
//   fixed, so repeated runs are bit-identical.
//
// The unit walk (unit_walk; CORR and the rows core): every point that a
//   Humlicek item (a line, an instance) may need a correction at takes one of
//   five region bodies by its own |x|, CPF12 about ten times the work of
//   region 1, and most in-window points need none, so lane = point over every
//   in-window point would idle and diverge.  Instead a block pass (CORR: over
//   each landed ring slot; the rows core: a thread an instance) turns each
//   item into {need window, c_int, c_frac}, {srw, y, pref, class code}
//   (pair_item): the class from y (CORR: the line's own; the rows core: the
//   group's min y; a NaN y takes class 4, the whole correction, as it
//   fails every test of the JAX conds), and the window narrowed to the
//   points that can need a correction (|x| < xlim0 widened for x's
//   roundings; a non-finite prefactor keeps its window, where pref * 0.0
//   is NaN).  A unit is an item with one
//   point group of 32 points its need window meets; a block scan numbers the
//   units in item order, and per pass of up to 256 units thread u classifies
//   unit u's points, lane = unit (the window, then x^2 < k1_limit in class 1,
//   or |x| < xlim0 and region_at's tests, as core_needs does), the block
//   lists the pairs by list (K1, regions 1, 2, 3, CPF12, or every in-window
//   point of a non-finite prefactor), the warps evaluate 32 pairs of one list
//   a round into a [unit][point] value block (list_value, the one copy of
//   each region body), and the warp that owns a point group adds the group's
//   units in unit order, item order, into its sums.  The block, not the warp
//   that owns the points, walks the units: a chunk's lines crowd onto few
//   points, where one warp's serial walk would be the time.  A skipped term
//   is +/-0.0 and a sum that starts at +0.0 never holds -0.0, so the bits are
//   those of every term added in order; no float atomics (integer ones place
//   a pair in its list, which changes no value).
//
// pylbl_rows: the rows core (replaces _rows_kernel, _rows_kernel_batched
//   and, with a separate [B, 1, G] min-y block, _rows_kernel_vmem).  A
//   group is 8 instances, one per row of the tile (row r holds points
//   r*tile/8 .. (r+1)*tile/8 - 1); its parameters are 64 rows, field f of
//   instance r in row f*8+r, the group's min y in row 56.  The instances'
//   windows are the lines' wing windows over the rows their core windows
//   meet.  One block of 8 warps per (piece of 32 groups, layer): the piece
//   is staged once with 16-byte cp.async copies (57 rows x 32 groups),
//   thread (r, g) makes instance r of group g item r * 32 + g, the block
//   walks the 256 items (the unit walk), and warp r sums row r's units into
//   one running sum per point and piece in group order; the pieces fold in
//   piece order (piece_fold).  The JAX kernels carry ONE sum per point
//   through the whole walk, so this order is a recorded deviation of the
//   port.
//
// Each entry returns cudaGetLastError() after its launch.

#include <cfloat>
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
              kSIdx = 5, kEIdx = 6, kPad = 7;
// Core parameter rows (SR_SEG0REL..SR_SLOT).
constexpr int kSeg0Rel = 0, kCoreCFrac = 1, kCoreSrw = 2, kCoreY = 3,
              kCorePref = 4, kSRel = 5, kERel = 6, kSlot = 7;

// Tile-kernel line functions (pylbl_wings' line_fn argument).
constexpr int kLinePre = 0, kLineRaw = 1, kLineCorr = 2, kLineOwn = 3;
// The Lorentzian walk: points per lane (a warp owns 32 * kWalkPoints
// consecutive points of the tile), floats per staged line, and the
// blocks of kWingsThreads an SM holds (the compiler keeps a thread within
// 32 registers, so the SM holds its 64 warps).
constexpr int kWalkPoints = 4;
constexpr int kLineFloats = 8;
constexpr int kWalkBlocks = 8;

// Where a staged line keeps SoA row r: the window first, so that a lane
// reads it as one 8-byte load, then the rest in row order:
// {S_IDX, E_IDX, C_INT, C_FRAC}, {SRW, Y, PREF, _PAD}.
__host__ __device__ constexpr int walk_slot(int r)
{
    return r == kSIdx ? 0 : r == kEIdx ? 1 : r < kSIdx ? r + 2 : r;
}
// Rows core: threads per block (8 warps, one per row), groups per chunk,
// groups per piece (ROWS_PIECE_GROUPS, one cp.async stage), and the min-y
// row of a group block.
constexpr int kRowsThreads = 256;
constexpr int kRowsChunk = 128;
constexpr int kRowsPiece = 32;
constexpr int kYminRow = 56;
// Mixed-slot core: warps of a block, slots of the largest tile, its
// pair lists (K1, regions 1, 2, 3 and CPF12, then the whole correction)
// and their room (every pair of a chunk, each list padded to whole
// rounds of 32), and the blocks an SM holds (the block's static shared
// memory allows 6).
constexpr int kCoreWarps = kCoreThreads / 32;
constexpr int kCoreSlots = kMaxTile / 32;
constexpr int kListK1 = 0, kListR1 = 1, kListAny = 5, kCoreLists = 6;
constexpr int kCoreListCap = kCoreThreads * 32 + kCoreLists * 32;
constexpr int kCoreBlocks = 6;

// Where val keeps instance i's offset o: row i, the offset swizzled by the
// instance, so that a round's scattered writes and a warp's row reads
// (lane = offset) fall in distinct banks.
__host__ __device__ constexpr int core_val(int i, int o)
{
    return i * 32 + (o ^ (i & 31));
}
// Segment-pass kinds (pylbl_seg's kind argument; the segment core's
// entries a block are its core_piece argument, ops/lineshape_cuda.py
// seg_core_piece); the segment wings' warps (entries) a block and blocks
// an SM; threads per block of the fold.
constexpr int kSegCore = 0, kSegWings = 1;
constexpr int kSegWingsWarps = 4;
constexpr int kSegWingsBlocks = 12;
constexpr int kFoldThreads = 256;

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

// A prepacked Lorentzian term (pref*y/sqrt(pi)) / (x^2 + y^2) as the
// IEEE reciprocal of the denominator times the numerator, two rounded
// operations (the plain version's pref_y * (1 / den)).
__device__ __forceinline__ float lorentz_term(float pref_y, float x,
                                              float ysq)
{
    return __fmul_rn(pref_y, __frcp_rn(x * x + ysq));
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

// The class of an item from y (CORR: the line's own y; the rows core: the
// group's min y; a core chunk: its instances' min y): 0 (skipped: y >=
// 70.55, every term +0.0), 1 (>= 8.425, K1), 2 (>= 6.8), 3 (>= 2.0), else
// 4.  A NaN y fails every test of the JAX conds and takes class 4, the
// whole correction: a NaN-y item itself lists nothing there but a
// non-finite prefactor's window (correction(x, NaN) is 0, pref * 0 NaN),
// and a rows group's other instances take theirs from their own y.
__device__ __forceinline__ int pair_class(float y)
{
    return y >= F(70.55) ? 0 : y >= F(8.425) ? 1 : y >= F(6.8) ? 2
        : y >= F(2.0) ? 3 : 4;
}

// voigt_correction_k1: y >= 8.425, one combined rational; a point needs
// it where x^2 < k1_limit(y) (and y < 70.55).
__device__ __forceinline__ float k1_limit(float y)
{
    return fmaxf(F(15100.0) + y * (F(40.0) - y * F(3.6)), 0.0f);
}

__device__ __forceinline__ float k1_value(float x, float y)
{
    const float xq = x * x;
    const float yq = y * y;
    const float a0 = yq + F(0.5);
    const float d0 = a0 * a0;
    const float d2 = (yq + yq) - F(1.0);
    const float num = (y * F(kRsqrpi)) * (F(1.5) * xq - (F(0.5) * yq
                                                         + F(0.25)));
    const float den = (d0 + xq * (d2 + xq)) * (xq + yq);
    return num / den;
}

__device__ __forceinline__ float corr_k1(float x, float y)
{
    const bool needs = (x * x < k1_limit(y)) && (y < F(70.55));
    return needs ? k1_value(x, y) : 0.0f;
}

// The Humlicek regions of corr_regions, in reference order.
constexpr int kRegion1 = 0, kRegion2 = 1, kRegion3 = 2, kRegionCpf = 3;

// The region corr_regions<cls> takes at |x| = abx for a point that needs
// a correction (abx < xlim0, y < 70.55).
__device__ __forceinline__ int region_of(int cls, float abx, float xlim1,
                                         float xlim2, float xlim3)
{
    if (abx >= xlim1) return kRegion1;
    if (cls == 2 || abx >= xlim2) return kRegion2;
    if (cls == 3 || abx < xlim3) return kRegion3;
    return kRegionCpf;
}

template <int CLASS>
__device__ __forceinline__ int region_at(float abx, const Limits& l)
{
    return region_of(CLASS, abx, l.xlim1, l.xlim2, l.xlim3);
}

// K_region - K_lorentz at x: the value corr_regions gives a point of
// REGION (yq and xlim4 as region_limits computes them).
template <int REGION>
__device__ __forceinline__ float region_correction(float x, float y)
{
    const float abx = fabsf(x);
    const float xq = abx * abx;
    const float yq = y * y;
    float inner;
    if (REGION == kRegion1) {
        inner = region1(xq, y, yq);
    } else if (REGION == kRegion2) {
        inner = region2(xq, y, yq);
    } else if (REGION == kRegion3) {
        inner = region3(xq, y);
    } else {
        inner = cpf12(x, xq, abx, y, F(18.1) * y + F(1.65));
    }
    return inner - lorentz(x, y);
}

// voigt_correction_k12 (regions 1-2), _k123 (regions 1-3) and the full
// form (regions 1-3 + CPF12), selected per point in reference order.
template <int CLASS>
__device__ __forceinline__ float corr_regions(float x, float y)
{
    const Limits l = region_limits(y);
    const float abx = fabsf(x);
    const bool needs = (abx < l.xlim0) && (y < F(70.55));
    if (!needs) return 0.0f;
    switch (region_at<CLASS>(abx, l)) {
    case kRegion1: return region_correction<kRegion1>(x, y);
    case kRegion2: return region_correction<kRegion2>(x, y);
    case kRegion3: return region_correction<kRegion3>(x, y);
    default: return region_correction<kRegionCpf>(x, y);
    }
}

template <int CLASS>
__device__ __forceinline__ float correction(float x, float y)
{
    if (CLASS == 1) return corr_k1(x, y);
    return corr_regions<CLASS>(x, y);
}

// ---- Piece split and ordered fold (shared by the tile and core kernels) --

// The host's piece list (ops/lineshape_cuda.py TilePieces): block x of a
// launch is piece x of tile tile[x]; tile t owns pieces first[t] ..
// first[t] + count[t] - 1 and, when count[t] > 1, the scratch slots
// slot[t] .. slot[t] + count[t] - 1 of each layer.  done[B, T] counts the
// finished pieces of each (layer, tile); the caller zeroes it.
struct Pieces {
    const int* tile;
    const int* first;
    const int* count;
    const int* slot;
    int num_slots;
    int piece;          // K: chunks per piece
    float* scratch;     // [B, num_slots, tile]
    int* done;          // [B, T]
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16 bytes; both addresses 16-byte aligned (L2 only, as .cg requires).
__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// Waits for every copy group of this thread but the newest.
__device__ __forceinline__ void cp_async_wait_prev()
{
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Waits for every copy group of this thread.
__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Where piece j of tile t writes its partial tile: the output tile itself
// when the tile is one piece, else the piece's scratch slot.
__device__ __forceinline__ float* piece_dst(const Pieces& pc, float* o,
                                            int b, int t, int j, int tile)
{
    if (pc.count[t] == 1) return o;
    return pc.scratch + ((long long)b * pc.num_slots + pc.slot[t] + j)
        * tile;
}

// After every thread wrote its part of piece_dst: the block that finishes
// a split tile's last piece adds the slots in piece order into ``o``.
__device__ __forceinline__ void piece_fold(const Pieces& pc, float* o,
                                           int b, int t, int num_tiles,
                                           int tile)
{
    __shared__ int last;
    const int n = pc.count[t];
    if (n == 1) return;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        last = atomicAdd(pc.done + (long long)b * num_tiles + t, 1) == n - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* s = pc.scratch + ((long long)b * pc.num_slots + pc.slot[t])
        * tile;
    for (int c = threadIdx.x; c < tile; c += blockDim.x) {
        float sum = 0.0f;
        for (int i = 0; i < n; ++i) sum = sum + __ldcg(s + (long long)i * tile
                                                       + c);
        o[c] = sum;
    }
}

// RAW's and OWN's line from its staged raw rows f1 = {srw, y, pref,
// _PAD}: the prepacked y^2 and pref*y/sqrt(pi), in the plain version's
// float32 order (_tile_partials_plain); OWN zeroes the strength of a line
// whose _PAD is not the tile (tile_f).
template <int LINE>
__device__ __forceinline__ void raw_line(float4 f1, float tile_f, float& ysq,
                                         float& pref_y)
{
    float strength = f1.z;
    if (LINE == kLineOwn) strength = f1.w == tile_f ? f1.z : 0.0f;
    pref_y = (strength * f1.y) * F(kRsqrpi);
    ysq = f1.y * f1.y;
}

// Whether OWN may leave out the staged line {f0, f1} (walk_slot order) on
// tile tile_f: a foreign line whose every term (0 * y / sqrt(pi)) *
// rcp(x^2 + y^2) is +/-0.0, which leaves a sum that is never -0.0
// unchanged.  That holds where y^2 is finite and normal (then x^2 + y^2 >=
// y^2 and its reciprocal is finite, or 0 at x^2 = inf) and x is never NaN
// (c_int, c_frac and srw finite, srw != 0: the offset from the center is
// finite or +/-inf, and so is x).  Any other foreign line stays.
__device__ __forceinline__ bool own_drops(float4 f0, float4 f1, float tile_f)
{
    const float ysq = f1.y * f1.y;
    return f1.w != tile_f && ysq >= FLT_MIN && ysq <= FLT_MAX
        && fabsf(f0.z) <= FLT_MAX && fabsf(f0.w) <= FLT_MAX
        && fabsf(f1.x) <= FLT_MAX && f1.x != 0.0f;
}

// The Lorentzian walk of PRE, RAW and OWN (see the note at the top).
// Block: tile / PPT threads; warp w owns the tile's points w*32*PPT ..
// (w+1)*32*PPT - 1, lane l the points w*32*PPT + 32j + l.  The ring holds
// two chunks (one for pieces of one chunk) line-major, 8 floats a line
// (walk_slot), in dynamic shared memory of max(chunk, tail) * 32 bytes a
// slot.
template <int PPT, int LINE>
__global__ void __launch_bounds__(kWingsThreads, kWalkBlocks)
lorentz_walk_kernel(const float* __restrict__ soa, long long soa_b,
                    long long soa_r, const int* __restrict__ w_start,
                    const int* __restrict__ w_n,
                    const int* __restrict__ t_start,
                    const int* __restrict__ t_n, long long csr_b,
                    float* __restrict__ out, int num_tiles, int tile,
                    int stride, int chunk, int tail, Pieces pc)
{
    constexpr int kSpan = 32 * PPT;
    // The rows before _PAD; OWN also stages _PAD (each line's tile).
    constexpr int kRows = LINE == kLineOwn ? kPad + 1 : kPad;
    constexpr bool kRaw = LINE != kLinePre;
    extern __shared__ float4 ring[];
    const int ring_lines = max(chunk, tail);
    const int b = blockIdx.y;
    const int t = pc.tile[blockIdx.x];
    const int piece = blockIdx.x - pc.first[t];
    const float tile_f = (float)t;
    const float* lines = soa + b * soa_b;
    const long long csr = b * csr_b + t;
    // The tile's walk: its main chunks, then its tail chunks.
    const int n_main = w_n[csr];
    const int n_walk = n_main + (t_start == nullptr ? 0 : t_n[csr]);
    const int k0 = piece * pc.piece;
    const int k1 = min(k0 + pc.piece, n_walk);
    const int lane = threadIdx.x & 31;
    const int offset = (threadIdx.x >> 5) * kSpan;   // the warp's first
    const float lo = (float)(t * stride + offset);
    const float hi = lo + (float)(kSpan - 1);

    float point[PPT], acc[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
        point[j] = lo + (float)(32 * j + lane);
        acc[j] = 0.0f;
    }
    auto width_of = [&](int k) { return k < n_main ? chunk : tail; };
    auto stage = [&](int k, int s) {
        const int width = width_of(k);
        const long long line0 = k < n_main
            ? (long long)w_start[csr] + (long long)k * chunk
            : (long long)t_start[csr] + (long long)(k - n_main) * tail;
        float* dst = reinterpret_cast<float*>(ring + 2LL * s * ring_lines);
        for (int i = threadIdx.x; i < kRows * width; i += blockDim.x) {
            const int r = i / width;
            const int l = i - r * width;
            cp_async4(dst + l * kLineFloats + walk_slot(r),
                      lines + r * soa_r + line0 + l);
        }
    };
    if (k0 < k1) stage(k0, 0);
    cp_async_commit();
    for (int k = k0; k < k1; ++k) {
        const int s = (k - k0) & 1;
        if (k + 1 < k1) stage(k + 1, s ^ 1);
        cp_async_commit();
        cp_async_wait_prev();
        __syncthreads();
        const float4* staged = ring + 2LL * s * ring_lines;
        const int width = width_of(k);
        if constexpr (kRaw) {
            // The prepacked rows in place; a line OWN leaves out gets an
            // empty window (window end -1 < every point), so it never meets.
            float4* raw = ring + 2LL * s * ring_lines;
            for (int l = threadIdx.x; l < width; l += blockDim.x) {
                float4 f1 = raw[2 * l + 1];
                if (LINE == kLineOwn && own_drops(raw[2 * l], f1, tile_f)) {
                    reinterpret_cast<float*>(raw + 2 * l)[1] = -1.0f;
                    continue;
                }
                raw_line<LINE>(f1, tile_f, f1.y, f1.z);
                raw[2 * l + 1] = f1;
            }
            __syncthreads();
        }
        float part[PPT];
#pragma unroll
        for (int j = 0; j < PPT; ++j) part[j] = 0.0f;
        for (int g = 0; g < width; g += 32) {
            // Lane l tests line g + l against the warp's points: ``meet``
            // lists the lines whose window reaches them, ``full`` those
            // whose window holds them all.
            const int l = g + lane;
            bool meets = false, covers = false;
            if (l < width) {
                const float2 w = reinterpret_cast<const float2*>(staged)[
                    l * (kLineFloats / 2)];
                meets = !(w.y < lo || w.x > hi);
                covers = w.x <= lo && w.y >= hi;
            }
            unsigned meet = __ballot_sync(0xffffffffu, meets);
            const unsigned full = __ballot_sync(0xffffffffu, covers);
            while (meet != 0u) {                 // warp-uniform, in order
                const int i = __ffs(meet) - 1;
                meet &= meet - 1u;
                // {ws, we, c_int, c_frac}, {srw, y^2, pref*y/sqrt(pi), -}.
                const float4 f0 = staged[2 * (g + i)];
                const float4 f1 = staged[2 * (g + i) + 1];
                if ((full >> i) & 1u) {
#pragma unroll
                    for (int j = 0; j < PPT; ++j) {
                        const float x = ((point[j] - f0.z) - f0.w) * f1.x;
                        part[j] = part[j] + lorentz_term(f1.z, x, f1.y);
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < PPT; ++j) {
                        // The 32 points of group j: warp-uniform test.
                        const float lo_j = lo + (float)(32 * j);
                        if (f0.y < lo_j || f0.x > lo_j + 31.0f) continue;
                        const float x = ((point[j] - f0.z) - f0.w) * f1.x;
                        const float val = lorentz_term(f1.z, x, f1.y);
                        const bool in = (point[j] >= f0.x)
                            && (point[j] <= f0.y);
                        part[j] = part[j] + (in ? val : 0.0f);
                    }
                }
            }
        }
#pragma unroll
        for (int j = 0; j < PPT; ++j) acc[j] = acc[j] + part[j];
        __syncthreads();   // the ring slot is restaged next iteration
    }
    float* o = out + ((long long)b * num_tiles + t) * tile;
    float* dst = piece_dst(pc, o, b, t, piece, tile) + offset + lane;
#pragma unroll
    for (int j = 0; j < PPT; ++j) dst[32 * j] = acc[j];
    piece_fold(pc, o, b, t, num_tiles, tile);
}

// ---- The mixed-slot core (pylbl_core_segmix; see the note at the top) ----

// Offset o's x of core instance i: seg0-relative, as _seg_chunk_accumulate
// (o a whole float).
__device__ __forceinline__ float core_x(const float (*prm)[kCoreThreads],
                                        int i, float o)
{
    return ((prm[kSeg0Rel][i] + o) - prm[kCoreCFrac][i]) * prm[kCoreSrw][i];
}

// Offsets 0..31 of instance i that need a correction, as bit masks by
// list, in the kernel's float32 arithmetic: the window test o in [s_rel,
// e_rel] as integer bounds, then x^2 < k1_limit (class 1: kListK1) or
// |x| < xlim0 and region_at's tests (kListR1 + region).  Every other
// in-window offset's correction is +0.0, so its term pref * 0.0 adds
// nothing.  An instance of a non-finite prefactor (a skipped term would
// be NaN, not +0.0) lists every in-window offset in kListAny, which
// evaluates the whole correction.  ``slots``: the tile's slots (a slot
// outside them adds nowhere, as in the plain version's one-hot).
template <int CLASS>
__device__ __forceinline__ void core_needs(const float (*prm)[kCoreThreads],
                                           int i, int slots,
                                           unsigned (&need)[kCoreLists])
{
#pragma unroll
    for (int r = 0; r < kCoreLists; ++r) need[r] = 0u;
    const float s_rel = prm[kSRel][i];
    const float e_rel = prm[kERel][i];
    const int slot = (int)prm[kSlot][i];
    if (!(e_rel >= 0.0f && s_rel <= 31.0f) || slot < 0 || slot >= slots)
        return;
    const float f0 = fmaxf(ceilf(s_rel), 0.0f);
    const float f1 = fminf(floorf(e_rel), 31.0f);
    if (f0 > f1) return;
    const int o0 = (int)f0, o1 = (int)f1;
    if (!isfinite(prm[kCorePref][i])) {
        need[kListAny] = (0xffffffffu >> (31 - o1)) & (0xffffffffu << o0);
        return;
    }
    const float y = prm[kCoreY][i];
    if (!(y < F(70.55))) return;
    if (CLASS == 1) {
        const float lim = k1_limit(y);
        unsigned k1 = 0u;
        float of = f0;
        for (unsigned bit = 1u << o0; bit <= 1u << o1 && bit; bit <<= 1) {
            const float x = core_x(prm, i, of);
            k1 |= x * x < lim ? bit : 0u;
            of = of + 1.0f;
        }
        need[kListK1] = k1;
        return;
    }
    const Limits l = region_limits(y);
    // region_at's tests as bit masks over the offsets.
    unsigned lt0 = 0u, ge1 = 0u, ge2 = 0u, lt3 = 0u;
    float of = f0;
    for (unsigned bit = 1u << o0; bit <= 1u << o1 && bit; bit <<= 1) {
        const float abx = fabsf(core_x(prm, i, of));
        lt0 |= abx < l.xlim0 ? bit : 0u;
        ge1 |= abx >= l.xlim1 ? bit : 0u;
        if (CLASS >= 3) ge2 |= abx >= l.xlim2 ? bit : 0u;
        if (CLASS == 4) lt3 |= abx < l.xlim3 ? bit : 0u;
        of = of + 1.0f;
    }
    // Region 1 at |x| >= xlim1, else region 2 (class 2, or |x| >= xlim2),
    // else region 3 (class 3, or |x| < xlim3), else CPF12.
    const unsigned r2 = CLASS == 2 ? ~0u : ge2;
    const unsigned r3 = CLASS == 3 ? ~0u : lt3;
    need[kListR1 + kRegion1] = lt0 & ge1;
    need[kListR1 + kRegion2] = lt0 & ~ge1 & r2;
    need[kListR1 + kRegion3] = lt0 & ~ge1 & ~r2 & r3;
    need[kListR1 + kRegionCpf] = lt0 & ~ge1 & ~r2 & ~r3;
}

// correction<cls>(x, y), out of line: the pairs of kListAny, which no plan
// gives (one copy of the bodies, kept out of the hot loop).
__device__ __noinline__ float any_correction(int cls, float x, float y)
{
    switch (cls) {
    case 1: return correction<1>(x, y);
    case 2: return correction<2>(x, y);
    case 3: return correction<3>(x, y);
    default: return correction<4>(x, y);
    }
}

// The correction of a pair of list ``lst`` (warp-uniform) in class
// ``cls`` at x: the value correction<cls>(x, y) gives the pair, by the
// same code, one copy of each region body.
__device__ __forceinline__ float list_value(int lst, int cls, float x,
                                            float y)
{
    switch (lst) {
    case kListK1: return k1_value(x, y);
    case kListR1 + kRegion1: return region_correction<kRegion1>(x, y);
    case kListR1 + kRegion2: return region_correction<kRegion2>(x, y);
    case kListR1 + kRegion3: return region_correction<kRegion3>(x, y);
    case kListR1 + kRegionCpf: return region_correction<kRegionCpf>(x, y);
    default: return any_correction(cls, x, y);
    }
}

// Evaluates entry e < end of list ``lst`` (warp-uniform) of a chunk of
// class ``cls``: val[i][o] = pref_i * correction, instance i = list[e] >>
// 5, offset o = list[e] & 31, swizzled by the instance (core_val).
__device__ __forceinline__ void core_eval(const float (*prm)[kCoreThreads],
                                          const unsigned short* list,
                                          float* val, int lst, int cls,
                                          int e, int end)
{
    if (e >= end) return;
    const int i = list[e] >> 5;
    const int o = list[e] & 31;
    const float x = core_x(prm, i, (float)o);
    val[core_val(i, o)] = prm[kCorePref][i]
        * list_value(lst, cls, x, prm[kCoreY][i]);
}

struct CoreShared {
    float prm[2][8][kCoreThreads];      // the cp.async ring of chunks
    float val[kCoreThreads * 32];       // pref * correction, core_val
    unsigned short list[kCoreListCap];  // (instance << 5 | offset) by list
    unsigned slot_of[kCoreSlots][kCoreWarps];  // warp w's live instances
    int count[kCoreWarps][kCoreLists];  // warp w's pairs of each list
    unsigned touched[kCoreWarps];       // the slots warp w's instances hit
    unsigned spread[kCoreSlots];        // core_spread's non-finite sums
};

// Lists the chunk's needed pairs, instance i = threadIdx.x with ``need``
// (core_needs): list r takes entries base[r] .. end[r] - 1 (base[r] in
// whole rounds of 32), instance i's pairs after those of the instances
// before it, in offset order; records each warp's live instances by slot
// (slot_of) and its slots (touched).  Returns the entries with padding
// (0: the chunk needs nothing; block-uniform).
__device__ __forceinline__ int core_lists(CoreShared& sh, int s,
                                          const unsigned (&need)[kCoreLists],
                                          int (&base)[kCoreLists],
                                          int (&end)[kCoreLists])
{
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    unsigned any = 0u;
#pragma unroll
    for (int r = 0; r < kCoreLists; ++r) any |= need[r];
    const bool live = any != 0u;
    const int slot = (int)sh.prm[s][kSlot][tid];
    const unsigned live_w = __ballot_sync(0xffffffffu, live);
    const unsigned same = __match_any_sync(0xffffffffu, slot) & live_w;
    if (live && lane == __ffs(same) - 1) sh.slot_of[slot][warp] = same;
    const unsigned hit = __reduce_or_sync(0xffffffffu,
                                          live ? 1u << slot : 0u);
    // Per-list pair counts: a warp scan of two 16-bit counts a word.
    unsigned own[kCoreLists / 2], inc[kCoreLists / 2];
#pragma unroll
    for (int q = 0; q < kCoreLists / 2; ++q) {
        own[q] = (unsigned)__popc(need[2 * q])
                 | (unsigned)__popc(need[2 * q + 1]) << 16;
        inc[q] = own[q];
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int q = 0; q < kCoreLists / 2; ++q) {
            const unsigned up = __shfl_up_sync(0xffffffffu, inc[q], d);
            if (lane >= d) inc[q] += up;
        }
    }
    if (lane == 31) {
#pragma unroll
        for (int r = 0; r < kCoreLists; ++r) {
            sh.count[warp][r] = (inc[r / 2] >> (16 * (r & 1))) & 0xffffu;
        }
        sh.touched[warp] = hit;
    }
    __syncthreads();
    int next = 0;
#pragma unroll
    for (int r = 0; r < kCoreLists; ++r) {
        int total = 0, before = 0;
#pragma unroll
        for (int w = 0; w < kCoreWarps; ++w) {
            const int c = sh.count[w][r];
            total += c;
            before += w < warp ? c : 0;
        }
        const unsigned field = (inc[r / 2] - own[r / 2]) >> (16 * (r & 1));
        int k = next + before + (int)(field & 0xffffu);
        for (unsigned m = need[r]; m != 0u; m &= m - 1u) {
            sh.list[k++] = (unsigned short)((tid << 5) | (__ffs(m) - 1));
        }
        base[r] = next;
        end[r] = next + total;
        next += (total + 31) & ~31;
    }
    return next;
}

// Adds the chunk's values into the piece accumulator (acc[k]: slot 4k +
// warp, lane = offset) in the order of the one-block walk: per slot, each
// warp group's live instances of the slot in order from +0.0 (the skipped
// instances' terms are +/-0.0, which leave a sum that is never -0.0
// unchanged), the groups as ((g0 + g1) + g2) + g3.  The values read are
// zeroed for the next chunk.
__device__ __forceinline__ void core_sum(CoreShared& sh,
                                         float (&acc)[kCoreSlots / 4])
{
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const unsigned hits = sh.touched[0] | sh.touched[1] | sh.touched[2]
                          | sh.touched[3];
#pragma unroll
    for (int k = 0; k < kCoreSlots / 4; ++k) {
        const int sl = 4 * k + warp;
        if (!((hits >> sl) & 1u)) continue;        // warp-uniform
        float total = 0.0f;
#pragma unroll 1
        for (int g = 0; g < kCoreWarps; ++g) {
            float part = 0.0f;
            for (unsigned m = sh.slot_of[sl][g]; m != 0u; m &= m - 1u) {
                const int c = core_val(32 * g + __ffs(m) - 1, lane);
                part = part + sh.val[c];
                sh.val[c] = 0.0f;
            }
            total = g == 0 ? part : total + part;
        }
        __syncwarp();
        if (lane < kCoreWarps) sh.slot_of[sl][lane] = 0u;
        acc[k] = acc[k] + total;
    }
}

// The plain version's one-hot slot select (as the TPU's one-hot product)
// adds 0 * v into every other slot of the tile, NaN where a value v is
// not finite (a non-finite prefactor, y = 0 at x = 0).  A slot's piece sum
// at offset o is not finite exactly where one of its terms was not (a sum
// of finite terms past FLT_MAX would count too, far beyond any line
// list's values), so at the piece's end each warp ballots its slots' sums
// into spread, and after a barrier a point of offset o in slot s takes
// NaN where another slot's sum at o is not finite.  NaN absorbs, so
// adding it at the piece's end gives the bits of adding it at its chunk.
__device__ __forceinline__ void core_spread(CoreShared& sh, int slots,
                                            float (&acc)[kCoreSlots / 4])
{
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kCoreSlots / 4; ++k) {
        const unsigned bad = __ballot_sync(0xffffffffu, !isfinite(acc[k]));
        if (lane == 0) sh.spread[4 * k + warp] = bad;
    }
    __syncthreads();
    unsigned all = 0u;
    for (int q = 0; q < slots; ++q) all |= sh.spread[q];
    if (all == 0u) return;                         // block-uniform
#pragma unroll
    for (int k = 0; k < kCoreSlots / 4; ++k) {
        const int sl = 4 * k + warp;
        unsigned others = 0u;
        for (int q = 0; q < slots; ++q)
            others |= q == sl ? 0u : sh.spread[q];
        if ((others >> lane) & 1u)
            acc[k] = acc[k] + __int_as_float(0x7fffffff);   // NaN
    }
}

// min.NaN: the smaller of a and b, NaN if either is (fminf drops a NaN).
__device__ __forceinline__ float fmin_nan(float a, float b)
{
    float d;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}

// The class of a core chunk from the min of its 128 y (its staged row),
// every warp for itself: no barrier.  A NaN y makes the min NaN, as the
// plain version's amin and jnp.min, and a NaN min fails every test of
// the JAX conds (_seg_chunk_accumulate), so the chunk takes class 4, the
// whole correction (pair_class); its NaN-y instances list nothing there
// (core_needs: not y < 70.55), as correction(x, NaN) is 0.
__device__ __forceinline__ int chunk_class(const float* yrow, int lane)
{
    float m = fmin_nan(fmin_nan(yrow[lane], yrow[lane + 32]),
                       fmin_nan(yrow[lane + 64], yrow[lane + 96]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        m = fmin_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
    return pair_class(m);
}

// Phases 1-3 of the core chunk in ring slot s, the one copy the mixed-slot
// core and the segment core run: the class from the chunk's min y, then
// classify (lane = instance, core_needs), list the needed pairs by a block
// scan (core_lists: each warp's live instances by slot in slot_of) and
// evaluate them 32 pairs of one list a round into the zeroed value block
// (core_eval).  Returns whether the value block holds any pair
// (block-uniform; false: the chunk adds +0.0 to every point).
__device__ __forceinline__ bool core_chunk(CoreShared& sh, int s, int slots)
{
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int cls = chunk_class(sh.prm[s][kCoreY], lane);
    if (cls == 0) return false;    // pure Lorentz chunk: no-op
    unsigned need[kCoreLists];
    switch (cls) {                 // block-uniform
    case 1: core_needs<1>(sh.prm[s], tid, slots, need); break;
    case 2: core_needs<2>(sh.prm[s], tid, slots, need); break;
    case 3: core_needs<3>(sh.prm[s], tid, slots, need); break;
    default: core_needs<4>(sh.prm[s], tid, slots, need);
    }
    int base[kCoreLists], end[kCoreLists];
    const int entries = core_lists(sh, s, need, base, end);
    if (entries == 0) return false;    // block-uniform: nothing needed
    __syncthreads();
    // Rounds of 32 entries of one list, round-robin over the warps.
    for (int q = warp * 32; q < entries; q += kCoreThreads) {
        int lst = 0;               // the list of round q: uniform
#pragma unroll
        for (int r = 1; r < kCoreLists; ++r) lst = q >= base[r] ? r : lst;
        int stop = end[0];
#pragma unroll
        for (int r = 1; r < kCoreLists; ++r) {
            stop = lst == r ? end[r] : stop;
        }
        core_eval(sh.prm[s], sh.list, sh.val, lst, cls, q + lane, stop);
    }
    __syncthreads();
    return true;
}

__global__ void __launch_bounds__(kCoreThreads, kCoreBlocks)
core_segmix_kernel(const float* __restrict__ params, long long p_b,
                   long long p_r, const int* __restrict__ tile_start,
                   const int* __restrict__ tile_chunks,
                   float* __restrict__ out, int num_tiles, int tile,
                   Pieces pc)
{
    __shared__ CoreShared sh;
    const int b = blockIdx.y;
    const int t = pc.tile[blockIdx.x];
    const int piece = blockIdx.x - pc.first[t];
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int slots = tile / 32;
    const float* p = params + b * p_b;

    for (int c = tid; c < kCoreThreads * 32; c += kCoreThreads)
        sh.val[c] = 0.0f;
    sh.slot_of[tid / kCoreWarps][tid % kCoreWarps] = 0u;
    float acc[kCoreSlots / 4];
#pragma unroll
    for (int k = 0; k < kCoreSlots / 4; ++k) acc[k] = 0.0f;
    const int first = tile_start[t];
    const int k0 = piece * pc.piece;
    const int k1 = min(k0 + pc.piece, tile_chunks[t]);
    auto stage = [&](int k, int s) {
        const long long col = (long long)(first + k) * kCoreThreads + tid;
#pragma unroll
        for (int r = 0; r < 8; ++r) cp_async4(&sh.prm[s][r][tid],
                                              p + r * p_r + col);
    };
    if (k0 < k1) stage(k0, 0);
    cp_async_commit();
    for (int k = k0; k < k1; ++k) {
        const int s = (k - k0) & 1;
        // Chunk k has landed, and every thread is done with chunk k - 1,
        // whose ring slot s ^ 1 takes chunk k + 1 while chunk k is worked.
        cp_async_wait_all();
        __syncthreads();
        if (k + 1 < k1) stage(k + 1, s ^ 1);
        cp_async_commit();
        if (core_chunk(sh, s, slots)) core_sum(sh, acc);
    }
    core_spread(sh, slots, acc);
    float* o = out + ((long long)b * num_tiles + t) * tile;
    float* dst = piece_dst(pc, o, b, t, piece, tile);
#pragma unroll
    for (int k = 0; k < kCoreSlots / 4; ++k) {
        if (4 * k + warp < slots) dst[(4 * k + warp) * 32 + lane] = acc[k];
    }
    piece_fold(pc, o, b, t, num_tiles, tile);
}

// ---- The unit walk (CORR and the rows core; see the notes at the top) --

// A walked item (a line of CORR's chunk, an instance of the rows core's
// piece) is two float4s in shared memory: {lo, hi, c_int, c_frac} and
// {srw, y, pref, code}; code is the class (1..4), plus kPairAny for a
// non-finite prefactor; [lo, hi] is the need window (pair_item).  A unit
// is an item with one point group of 32 points its need window meets; a
// pass takes up to kUnitCap units, one a thread.
constexpr int kPairAny = 8;
constexpr int kUnitCap = 256;
constexpr int kUnitListCap = kUnitCap * 32 + kCoreLists * 32;
// Blocks an SM holds by the walks' dynamic shared memory (CORR's 67 KB
// with its ring of one slot, the rows core's 66 KB).
constexpr int kPairBlocks = 3;

struct UnitShared {
    float val[kUnitCap * 32];              // pref * correction, core_val
    float u_lo[kUnitCap];                  // the pass's units: first point
    int count[kCoreLists];                 // the pass's pairs by list
    int cursor[kCoreLists];
    int scan[kUnitCap / 32];               // the block scan's warp sums
    unsigned short u_item[kUnitCap];       // and item
    unsigned short first[kMaxChunk + 1];   // item i's units first[i] ..
    unsigned short list[kUnitListCap];     // (unit << 5 | point) by list
};

// The walked item of window w = {ws, we, c_int, c_frac} and f = {srw, y,
// pref, -} in class ``cls``: a = w with the need window in place of [ws,
// we], b = {srw, y, pref, code}.  A point outside [ws, we] adds +0.0;
// inside it a point needs a correction only where y < 70.55 and |x| <
// xlim0 (x^2 < k1_limit in class 1), else its term is pref * 0.0, +/-0.0
// for a finite prefactor, which leaves a sum that is never -0.0 unchanged.
// Such a point p lies within c -/+ H, c = c_int + c_frac, H = xlim0 / |srw|
// widened by 2^-10 for x's three roundings, when |c_int|, |c_frac| and H
// are at most 2^21: then p - c_int is exact for |p| <= 2^23, a point
// beyond is more than 2^21 from c, and c and c -/+ H round by at most 0.25
// and 0.5, so [floor(c - H) - 1, ceil(c + H) + 1] within [ws, we] holds
// every such point; otherwise the window stays [ws, we].  A non-finite
// prefactor keeps [ws, we] (pref * 0.0 is NaN there); an item of class 0,
// or of y >= 70.55 or NaN (the rows core's class is the group's; a NaN y
// is class 4), gets the empty window [0, -1].
__device__ __forceinline__ void pair_item(float4 w, float4 f, int cls,
                                          float4& a, float4& b)
{
    const float y = f.y;
    a = w;
    b = make_float4(f.x, y, f.z, (float)cls);
    if (cls != 0 && !isfinite(f.z)) {
        b.w = (float)(cls + kPairAny);
        return;
    }
    if (cls == 0 || !(y < F(70.55))) {
        a.x = 0.0f;
        a.y = -1.0f;
        return;
    }
    const float xlim0 = cls == 1 ? sqrtf(k1_limit(y)) : region_limits(y).xlim0;
    constexpr float kFar = 2097152.0f;   // 2^21
    const float h = (xlim0 / fabsf(f.x)) * F(1.0009765625);
    if (h <= kFar && fabsf(w.z) <= kFar && fabsf(w.w) <= kFar) {
        const float c = w.z + w.w;
        const float lo = floorf(c - h) - 1.0f;
        const float hi = ceilf(c + h) + 1.0f;
        a.x = lo > w.x ? lo : w.x;   // a NaN window stays NaN
        a.y = hi < w.y ? hi : w.y;
    }
}

// The point groups of item a's need window within its span of ``sg``
// groups from slo: the count, and the first in g0.
__device__ __forceinline__ int unit_groups(float4 a, float slo, int sg,
                                           int& g0)
{
    const float shi = slo + (float)(32 * sg - 1);
    if (!(a.y >= slo && a.x <= shi)) return 0;
    g0 = (int)floorf((fmaxf(a.x, slo) - slo) * F(0.03125));
    return (int)floorf((fminf(a.y, shi) - slo) * F(0.03125)) - g0 + 1;
}

// The points of one unit (item {a, b}, its group's first point lo) that
// need a correction, as bit masks by list, in the kernels' float32
// arithmetic: the point in the need window, then x^2 < k1_limit (class 1:
// kListK1) or |x| < xlim0 and region_at's tests (kListR1 + region), the
// limits of y formed here; a non-finite prefactor lists every point in its
// window (kListAny).
__device__ __forceinline__ void unit_needs(float4 a, float4 b, float lo,
                                           unsigned (&need)[kCoreLists])
{
#pragma unroll
    for (int r = 0; r < kCoreLists; ++r) need[r] = 0u;
    // o0 .. o1 bound the window's points; each is tested as it is.
    const float f0 = fmaxf(ceilf(a.x - lo) - 1.0f, 0.0f);
    const float f1 = fminf(floorf(a.y - lo) + 1.0f, 31.0f);
    if (!(f0 <= f1)) return;
    const int code = (int)b.w;
    const int cls = code & 7;
    Limits lim;
    if (code & kPairAny) {
        lim.xlim0 = 0.0f;
    } else if (cls == 1) {
        lim.xlim0 = k1_limit(b.y);
    } else {
        lim = region_limits(b.y);
    }
    for (int o = (int)f0; o <= (int)f1; ++o) {
        const float p = lo + (float)o;
        if (!(p >= a.x && p <= a.y)) continue;
        const unsigned bit = 1u << o;
        if (code & kPairAny) {
            need[kListAny] |= bit;
            continue;
        }
        const float x = ((p - a.z) - a.w) * b.x;
        if (cls == 1) {
            need[kListK1] |= x * x < lim.xlim0 ? bit : 0u;
            continue;
        }
        const float abx = fabsf(x);
        if (abx < lim.xlim0) {
            const int reg = region_of(cls, abx, lim.xlim1, lim.xlim2,
                                      lim.xlim3);
#pragma unroll
            for (int q = 0; q < 4; ++q)
                need[kListR1 + q] |= reg == q ? bit : 0u;
        }
    }
}

// The unit walk of n items in order (item i: ab[2i], ab[2i + 1])
// by the whole block, into part: warp w's G point groups of 32 points.
// An item's span is ``sg`` point groups from base; ROWS: from base + (i /
// 32) * 32 sg, the row of instance i = r * 32 + g, and warp r owns row r
// (part[j]: its group j); else warp w owns the block's groups w, w +
// warps, ... (part[j]: group j * warps + w), so that a few busy groups
// spread over the warps.  A block scan numbers each item's units in item
// order (first); then per pass of up to kUnitCap units, thread u finds
// unit u's item, classifies its points (unit_needs), the block lists the
// pairs by list (counts, then each thread's pairs at a cursor; an entry's
// place within its list changes no value), the warps evaluate 32 pairs of
// one list a round into the value block (list_value, the one copy of each
// region body), and warp w adds the pass's units of its points in unit
// order, item order within a point group, zeroing the values it reads.
// A unit's points that need nothing are +0.0 in the value block, and a sum
// that starts at +0.0 never holds -0.0, so the bits are those of every
// term added in order.
template <int G, bool ROWS>
__device__ __forceinline__ void unit_walk(UnitShared& u, const float4* ab,
                                          int n, float base, int sg,
                                          float (&part)[G])
{
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int threads = blockDim.x;
    const int warps = threads >> 5;
    auto span_lo = [&](int i) {
        return ROWS ? base + (float)((i >> 5) * 32 * sg) : base;
    };
    // Each thread's run of items, their units, and a block scan.
    const int per = (n + threads - 1) / threads;
    const int i0 = min(tid * per, n);
    const int i1 = min(i0 + per, n);
    int mine = 0;
    for (int i = i0; i < i1; ++i) {
        int g0;
        mine += unit_groups(ab[2 * i], span_lo(i), sg, g0);
    }
    int inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += up;
    }
    if (lane == 31) u.scan[warp] = inc;
    __syncthreads();
    int total = 0, next = inc - mine;
    for (int w = 0; w < threads / 32; ++w) {
        const int c = u.scan[w];
        total += c;
        next += w < warp ? c : 0;
    }
    for (int i = i0; i < i1; ++i) {
        u.first[i] = (unsigned short)next;
        int g0;
        next += unit_groups(ab[2 * i], span_lo(i), sg, g0);
    }
    __syncthreads();
    const int cap = min(threads, kUnitCap);
    // Warp w's points: its row (ROWS), else its groups of the block's.
    const float w_lo = base + (float)(ROWS ? warp * 32 * sg : 0);
    for (int p0 = 0; p0 < total; p0 += cap) {     // block-uniform passes
        const int nu = min(cap, total - p0);
        unsigned need[kCoreLists];
#pragma unroll
        for (int r = 0; r < kCoreLists; ++r) need[r] = 0u;
        if (tid < nu) {
            // Unit p0 + tid: the last item whose units start at or before.
            const int un = p0 + tid;
            int lo_i = 0, hi_i = n - 1;
            while (lo_i < hi_i) {
                const int mid = (lo_i + hi_i + 1) >> 1;
                if ((int)u.first[mid] <= un) lo_i = mid;
                else hi_i = mid - 1;
            }
            const float4 a = ab[2 * lo_i];
            int g0;
            unit_groups(a, span_lo(lo_i), sg, g0);
            const float lo = span_lo(lo_i)
                + (float)(32 * (g0 + un - (int)u.first[lo_i]));
            u.u_item[tid] = (unsigned short)lo_i;
            u.u_lo[tid] = lo;
            unit_needs(a, ab[2 * lo_i + 1], lo, need);
        }
#pragma unroll
        for (int r = 0; r < kCoreLists; ++r) {
            const unsigned c = __reduce_add_sync(0xffffffffu,
                                                 (unsigned)__popc(need[r]));
            if (lane == 0 && c != 0u) atomicAdd(&u.count[r], (int)c);
        }
        __syncthreads();
        int start[kCoreLists + 1];
        start[0] = 0;
#pragma unroll
        for (int r = 0; r < kCoreLists; ++r)
            start[r + 1] = start[r] + ((u.count[r] + 31) & ~31);
#pragma unroll
        for (int r = 0; r < kCoreLists; ++r) {
            if (need[r] == 0u) continue;
            int k = start[r] + atomicAdd(&u.cursor[r], __popc(need[r]));
            for (unsigned m = need[r]; m != 0u; m &= m - 1u)
                u.list[k++] = (unsigned short)((tid << 5) | (__ffs(m) - 1));
        }
        __syncthreads();
        // Rounds of 32 entries of one list, round-robin over the warps.
        const int entries = start[kCoreLists];
        for (int q = warp * 32; q < entries; q += threads) {
            int lst = 0;                      // the list of round q: uniform
#pragma unroll
            for (int r = 1; r < kCoreLists; ++r) lst = q >= start[r] ? r : lst;
            const int e = q + lane;
            if (e < start[lst] + u.count[lst]) {
                const int entry = u.list[e];
                const int uu = entry >> 5;
                const int o = entry & 31;
                const int i = u.u_item[uu];
                const float4 a = ab[2 * i];
                const float4 b = ab[2 * i + 1];
                const float x = (((u.u_lo[uu] + (float)o) - a.z) - a.w) * b.x;
                u.val[core_val(uu, o)] = b.z
                    * list_value(lst, (int)b.w & 7, x, b.y);
            }
        }
        __syncthreads();
        // Warp w's units, in unit order.
        for (int u0 = 0; u0 < nu; u0 += 32) {
            int j = -1;
            if (u0 + lane < nu) {
                const int g = (int)((u.u_lo[u0 + lane] - w_lo) * F(0.03125));
                if (ROWS) j = g >= 0 && g < G ? g : -1;
                else j = g % warps == warp ? g / warps : -1;
            }
            for (unsigned m = __ballot_sync(0xffffffffu, j >= 0); m != 0u;
                 m &= m - 1u) {
                const int k = __ffs(m) - 1;
                const int uu = u0 + k;
                const int jk = __shfl_sync(0xffffffffu, j, k);
                const int c = core_val(uu, lane);
                const float v = u.val[c];
                u.val[c] = 0.0f;
#pragma unroll
                for (int q = 0; q < G; ++q) {
                    if (q == jk) part[q] = part[q] + v;
                }
            }
        }
        if (tid < kCoreLists) u.count[tid] = u.cursor[tid] = 0;
        __syncthreads();
    }
}

// Zeroes the walk's value block and list counts (a barrier follows before
// the first walk).
__device__ __forceinline__ void unit_start(UnitShared& u)
{
    for (int c = threadIdx.x; c < kUnitCap * 32; c += blockDim.x)
        u.val[c] = 0.0f;
    if (threadIdx.x < kCoreLists) u.count[threadIdx.x] =
        u.cursor[threadIdx.x] = 0;
}

// CORR (see the note at the top): tile / (32 G) warps, warp w owning the
// tile's point groups w, w + warps, ... for the sums; dynamic shared
// memory: the ring of one or two slots of max(chunk, tail) lines x 8
// floats (walk_slot order; a block pass rewrites each landed line into
// its item, pair_item), then the walk's UnitShared.
template <int G>
__global__ void __launch_bounds__(kWingsThreads, kPairBlocks)
corr_walk_kernel(const float* __restrict__ soa, long long soa_b,
                 long long soa_r, const int* __restrict__ w_start,
                 const int* __restrict__ w_n,
                 const int* __restrict__ t_start,
                 const int* __restrict__ t_n, long long csr_b,
                 float* __restrict__ out, int num_tiles, int tile,
                 int stride, int chunk, int tail, Pieces pc)
{
    extern __shared__ float4 corr_smem[];
    const int ring_lines = max(chunk, tail);
    float4* ring = corr_smem;
    UnitShared& u = *reinterpret_cast<UnitShared*>(
        ring + (pc.piece > 1 ? 4 : 2) * ring_lines);
    const int b = blockIdx.y;
    const int t = pc.tile[blockIdx.x];
    const int piece = blockIdx.x - pc.first[t];
    const float* lines = soa + b * soa_b;
    const long long csr = b * csr_b + t;
    // The tile's walk: its main chunks, then its tail chunks.
    const int n_main = w_n[csr];
    const int n_walk = n_main + (t_start == nullptr ? 0 : t_n[csr]);
    const int k0 = piece * pc.piece;
    const int k1 = min(k0 + pc.piece, n_walk);
    const int lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    const float base = (float)(t * stride);
    unit_start(u);

    float acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = 0.0f;
    auto width_of = [&](int k) { return k < n_main ? chunk : tail; };
    auto stage = [&](int k, int s) {
        const int width = width_of(k);
        const long long line0 = k < n_main
            ? (long long)w_start[csr] + (long long)k * chunk
            : (long long)t_start[csr] + (long long)(k - n_main) * tail;
        float* dst = reinterpret_cast<float*>(ring + 2LL * s * ring_lines);
        for (int i = threadIdx.x; i < kPad * width; i += blockDim.x) {
            const int r = i / width;
            const int l = i - r * width;
            cp_async4(dst + l * kLineFloats + walk_slot(r),
                      lines + r * soa_r + line0 + l);
        }
    };
    if (k0 < k1) stage(k0, 0);
    cp_async_commit();
    for (int k = k0; k < k1; ++k) {
        const int s = (k - k0) & 1;
        if (k + 1 < k1) stage(k + 1, s ^ 1);
        cp_async_commit();
        cp_async_wait_prev();
        __syncthreads();
        float4* items = ring + 2LL * s * ring_lines;
        const int width = width_of(k);
        // Each line's item in place, its class from its own y.
        for (int l = threadIdx.x; l < width; l += blockDim.x) {
            const float4 f = items[2 * l + 1];
            float4 a, bb;
            pair_item(items[2 * l], f, pair_class(f.y), a, bb);
            items[2 * l] = a;
            items[2 * l + 1] = bb;
        }
        __syncthreads();
        float part[G];
#pragma unroll
        for (int j = 0; j < G; ++j) part[j] = 0.0f;
        unit_walk<G, false>(u, items, width, base, tile / 32, part);
#pragma unroll
        for (int j = 0; j < G; ++j) acc[j] = acc[j] + part[j];
        __syncthreads();   // the ring slot is restaged next iteration
    }
    float* o = out + ((long long)b * num_tiles + t) * tile;
    float* dst = piece_dst(pc, o, b, t, piece, tile)
        + (threadIdx.x >> 5) * 32 + lane;
#pragma unroll
    for (int j = 0; j < G; ++j) dst[32 * warps * j] = acc[j];
    piece_fold(pc, o, b, t, num_tiles, tile);
}

// ---- The segment pass (pylbl_seg; see the note at the top) ----

__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// One thread: the ``bytes`` of src to shared dst with the TMA's bulk copy,
// counted on ``bar``, whose phase that thread's arrival (with the count)
// completes once they have landed.
__device__ __forceinline__ void bulk_expect(unsigned long long* bar,
                                            unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar)) : "memory");
}

// Waits until ``bar`` has completed the phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity)
{
    unsigned done = 0;
    while (!done) {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                     "\n selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    }
}

// The segment core: block x walks entries x K .. x K + K - 1 (K =
// ``piece``) of the stream-ordered list, layer blockIdx.y, and writes
// each entry's chunk sum to sums[b, e, :] on its own (no accumulator, so
// no value depends on K).  Per entry, the mixed-slot core's phases on one
// slot (core_chunk: every instance of a segment chunk is in slot 0), then
// core_sum's order for slot 0, its warp groups summed in parallel: warp g
// adds group g's live instances in order from +0.0, zeroing the values it
// reads, and warp 0 takes ((g0 + g1) + g2) + g3.  Rows 0-6 of the next
// entry are staged while this one is worked, one TMA bulk copy (512
// contiguous, 16-byte-aligned bytes) a row onto the ring slot's mbarrier
// (2.5% faster than 16-byte cp.async on E x 16, PERF.md); the slot row is
// never read from memory: it is 0 in both ring slots.
__global__ void __launch_bounds__(kCoreThreads, kCoreBlocks)
seg_core_kernel(const float* __restrict__ params, long long p_b,
                long long p_r, const int* __restrict__ ent_chunk,
                int num_entries, int piece, float* __restrict__ sums)
{
    __shared__ __align__(16) CoreShared sh;
    __shared__ float group_sum[kCoreWarps][32];
    __shared__ __align__(8) unsigned long long bar[2];
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const float* p = params + b * p_b;
    const int e0 = blockIdx.x * piece;
    const int e1 = min(e0 + piece, num_entries);

    for (int c = tid; c < kCoreThreads * 32; c += kCoreThreads)
        sh.val[c] = 0.0f;
    if (tid < kCoreWarps) sh.slot_of[0][tid] = 0u;
    sh.prm[0][kSlot][tid] = 0.0f;
    sh.prm[1][kSlot][tid] = 0.0f;
    if (tid == 0) {
        mbar_init(&bar[0]);
        mbar_init(&bar[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    constexpr int kRowBytes = kCoreThreads * sizeof(float);
    // One thread stages entry k into ring slot s (the proxy fence orders
    // the block's reads of the slot's last entry before the copy).
    auto stage = [&](int k, int s) {
        if (tid != 0) return;
        const float* src = p + (long long)ent_chunk[k] * kCoreThreads;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_expect(&bar[s], kSlot * kRowBytes);
        for (int r = 0; r < kSlot; ++r)
            bulk_copy(sh.prm[s][r], src + r * p_r, kRowBytes, &bar[s]);
    };
    if (e0 < e1) stage(e0, 0);
    for (int k = e0; k < e1; ++k) {
        const int s = (k - e0) & 1;
        // Entry k has landed (use (k - e0) / 2 of its slot's barrier), and
        // every thread is done with entry k - 1, whose ring slot s ^ 1
        // takes entry k + 1 while entry k is worked.
        mbar_wait(&bar[s], ((k - e0) >> 1) & 1);
        __syncthreads();
        if (k + 1 < e1) stage(k + 1, s ^ 1);
        const bool any = core_chunk(sh, s, 1);
        if (any) {                     // block-uniform
            float part = 0.0f;
            for (unsigned m = sh.slot_of[0][warp]; m != 0u; m &= m - 1u) {
                const int c = core_val(32 * warp + __ffs(m) - 1, lane);
                part = part + sh.val[c];
                sh.val[c] = 0.0f;
            }
            __syncwarp();
            if (lane == 0) sh.slot_of[0][warp] = 0u;
            group_sum[warp][lane] = part;
            __syncthreads();
        }
        if (warp == 0) {
            float total = 0.0f;
            if (any) {
                total = group_sum[0][lane];
#pragma unroll
                for (int g = 1; g < kCoreWarps; ++g)
                    total = total + group_sum[g][lane];
            }
            sums[((long long)b * num_entries + k) * 32 + lane] = total;
        }
    }
}

// The lanes l whose point lo + l lies in the window [ws, we], as bits:
// l >= ws - lo and l <= we - lo, exact where it decides (ws - lo and
// we - lo near 0..31 are exact float differences, Sterbenz; beyond, their
// rounding cannot cross 0 or 31); a NaN edge gives none, as the plain
// version's comparisons.
__device__ __forceinline__ unsigned seg_lane_mask(float2 w, float lo)
{
    const float a = ceilf(w.x - lo);
    const float b = floorf(w.y - lo);
    if (!(a <= b && b >= 0.0f && a <= 31.0f)) return 0u;
    const int ia = (int)fmaxf(a, 0.0f);
    const int ib = (int)fminf(b, 31.0f);
    return (0xffffffffu >> (31 - ib)) & (0xffffffffu << ia);
}

// The segment wings' term of staged instance i = {f0, f1} (walk_slot
// order, f1 prepacked: {srw, y^2, pref*y/sqrt(pi), lane mask}) at
// ``point``, lane bit ``lane_bit``: the IEEE quotient of the plain
// version where the point lies in the window, else +0.0.
__device__ __forceinline__ float seg_wings_term(const float4* g, int i,
                                                float point,
                                                unsigned lane_bit)
{
    const float4 f0 = g[2 * i];
    const float4 f1 = g[2 * i + 1];
    const float x = ((point - f0.z) - f0.w) * f1.x;
    const float val = f1.z / (x * x + f1.y);
    return __float_as_uint(f1.w) & lane_bit ? val : 0.0f;
}

// The segment wings: warp w of block x walks entry e = x W + w (W =
// kSegWingsWarps) of the stream-ordered list, layer blockIdx.y, with no
// block barrier: the warp stages the entry's 7 rows with 16-byte cp.async
// and takes its four groups of 32 instances in turn (warp partial w of
// the chunk sum is group w).  Per group, lane l rewrites instance l
// line-major into the warp's 1 KB line block (walk_slot: a term reads an
// instance as two 16-byte broadcasts): y^2 and pref*y/sqrt(pi) in the
// plain version's float32 order, and in the eighth float the lanes its
// window holds (seg_lane_mask); a ballot lists the instances whose window
// reaches the segment lo .. lo + 31.  An instance that misses it adds
// +0.0 to every point, which leaves a sum that starts at +0.0 unchanged:
// it is skipped, never loaded.  A group whose instances all reach the
// segment (most groups: a chunk holds one stream's lines) takes its 32
// terms unrolled, with no bit walk; else the warp walks the set bits in
// order.  Lane = offset, each term masked by its lane bit (an AND and a
// select; a window that holds the segment keeps every term).  The other
// warps of the SM hide the wait for the rows.
__global__ void __launch_bounds__(kSegWingsWarps * 32, kSegWingsBlocks)
seg_wings_kernel(const float* __restrict__ params, long long p_b,
                 long long p_r, const int* __restrict__ ent_chunk,
                 const int* __restrict__ ent_stream, int num_entries,
                 float* __restrict__ sums)
{
    __shared__ float4 rows_sh[kSegWingsWarps][kPad * 32];
    __shared__ float4 line_sh[kSegWingsWarps][2 * 32];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y;
    const int e = blockIdx.x * kSegWingsWarps + warp;
    if (e >= num_entries) return;
    const float* src = params + b * p_b + (long long)ent_chunk[e]
        * kCoreThreads + 4 * lane;
    float4* dst = rows_sh[warp];
#pragma unroll
    for (int r = 0; r < kPad; ++r)
        cp_async16(reinterpret_cast<float*>(dst + r * 32 + lane),
                   src + r * p_r);
    cp_async_commit();
    float4* g = line_sh[warp];
    const unsigned lane_bit = 1u << lane;
    const float lo = (float)(32 * ent_stream[e]);
    const float hi = lo + 31.0f;
    const float point = lo + (float)lane;
    cp_async_wait_all();
    __syncwarp();
    const float* rows = reinterpret_cast<const float*>(dst);
    float total = 0.0f;
    for (int w = 0; w < 4; ++w) {
        const int i = 32 * w + lane;
        const float ws = rows[kSIdx * kCoreThreads + i];
        const float we = rows[kEIdx * kCoreThreads + i];
        const float y = rows[kY * kCoreThreads + i];
        g[2 * lane] = make_float4(ws, we, rows[kCInt * kCoreThreads + i],
                                  rows[kCFrac * kCoreThreads + i]);
        g[2 * lane + 1] = make_float4(
            rows[kSrw * kCoreThreads + i], y * y,
            (rows[kPref * kCoreThreads + i] * y) * F(kRsqrpi),
            __uint_as_float(seg_lane_mask(make_float2(ws, we), lo)));
        unsigned meet = __ballot_sync(0xffffffffu, !(we < lo || ws > hi));
        __syncwarp();
        float part = 0.0f;
        if (meet == 0xffffffffu) {     // warp-uniform
#pragma unroll
            for (int j = 0; j < 32; ++j)
                part = part + seg_wings_term(g, j, point, lane_bit);
        }
        while (meet != 0xffffffffu && meet != 0u) {    // in order
            const int j = __ffs(meet) - 1;
            meet &= meet - 1u;
            part = part + seg_wings_term(g, j, point, lane_bit);
        }
        total = w == 0 ? part : total + part;
        __syncwarp();                  // the group's lines are rewritten
    }
    sums[((long long)b * num_entries + e) * 32 + lane] = total;
}

// Point p of layer b's [T * tile] output lies in stream p / 32 (tile
// p / tile, slot p % tile / 32); it adds that stream's entries
// stream_ptr[s] .. stream_ptr[s + 1] - 1 in order from +0.0.
__global__ void __launch_bounds__(kFoldThreads)
seg_fold_kernel(const float* __restrict__ sums, const int* __restrict__ ptr,
                int num_entries, int num_points, float* __restrict__ out)
{
    const int b = blockIdx.y;
    const int p = blockIdx.x * kFoldThreads + threadIdx.x;
    if (p >= num_points) return;
    const int s = p >> 5;
    const float* src = sums + (long long)b * num_entries * 32 + (p & 31);
    float acc = 0.0f;
    for (int e = ptr[s]; e < ptr[s + 1]; ++e)
        acc = acc + src[(long long)e * 32];
    out[(long long)b * num_points + p] = acc;
}

// The rows core's block: the piece's 32 groups of the 56 parameter rows
// and the min-y row, its 256 items (instance r of group g: item r * 32 +
// g), then the walk's UnitShared.
struct RowsShared {
    float grp[kYminRow + 1][kRowsPiece];
    float4 item[2 * 8 * kRowsPiece];
    UnitShared u;
};

// G = point groups of a row = tile / 256 (the row is 32 * G points wide).
// SEP_YMIN: the class comes from the separate min-y block, not row 56.
// Piece j of tile t walks groups 32j .. 32j + 31 of the tile's walk of
// 128 * g_n[t] groups (whole chunks, so every piece of a walk is full; an
// empty tile's one piece adds nothing).  The caller guarantees 16-byte
// aligned rows and g_start[t] a multiple of 4 groups, so the piece is
// staged in whole 16-byte copies.  Dynamic shared memory: RowsShared.
template <int G, bool SEP_YMIN>
__global__ void __launch_bounds__(kRowsThreads, kPairBlocks)
rows_kernel(const float* __restrict__ groups, long long g_b, long long g_r,
            const float* __restrict__ ymin, long long y_b,
            const int* __restrict__ g_start, const int* __restrict__ g_n,
            float* __restrict__ out, int num_tiles, int tile, Pieces pc)
{
    extern __shared__ float4 rows_smem[];
    RowsShared& sh = *reinterpret_cast<RowsShared*>(rows_smem);
    const int b = blockIdx.y;
    const int t = pc.tile[blockIdx.x];
    const int piece = blockIdx.x - pc.first[t];
    const int tid = threadIdx.x;
    const int r = tid >> 5;
    const int lane = tid & 31;
    const int row_w = 32 * G;
    const float* gp = groups + b * g_b;
    const float* yrow = SEP_YMIN ? ymin + b * y_b : gp + kYminRow * g_r;
    const int g0 = piece * kRowsPiece;
    unit_start(sh.u);

    float acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = 0.0f;
    if (g0 < g_n[t] * kRowsChunk) {   // block-uniform
        const long long col = (long long)g_start[t] + g0;
        for (int i = tid; i < (kYminRow + 1) * (kRowsPiece / 4);
             i += kRowsThreads) {
            const int row = i / (kRowsPiece / 4);
            const int q = 4 * (i - row * (kRowsPiece / 4));
            const float* src = row < kYminRow ? gp + row * g_r : yrow;
            cp_async16(&sh.grp[row][q], src + col + q);
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        // Thread (r, g): instance r of group g, its class from the group's
        // min y.
        const float4 win = make_float4(sh.grp[5 * 8 + r][lane],
                                       sh.grp[6 * 8 + r][lane],
                                       sh.grp[0 * 8 + r][lane],
                                       sh.grp[1 * 8 + r][lane]);
        const float4 f = make_float4(sh.grp[2 * 8 + r][lane],
                                     sh.grp[3 * 8 + r][lane],
                                     sh.grp[4 * 8 + r][lane], 0.0f);
        float4 a, bb;
        pair_item(win, f, pair_class(sh.grp[kYminRow][lane]), a, bb);
        sh.item[2 * tid] = a;
        sh.item[2 * tid + 1] = bb;
        __syncthreads();
        const float base = (float)(t * tile);
        unit_walk<G, true>(sh.u, sh.item, 8 * kRowsPiece, base, G, acc);
    }
    float* o = out + ((long long)b * num_tiles + t) * tile;
    float* dst = piece_dst(pc, o, b, t, piece, tile) + r * row_w + lane;
#pragma unroll
    for (int j = 0; j < G; ++j) dst[32 * j] = acc[j];
    piece_fold(pc, o, b, t, num_tiles, tile);
}

// Lets the kernel's next launch on the current device take ``bytes`` of
// dynamic shared memory (above the 48 KB default).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes)
{
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int G, bool SEP_YMIN>
int launch_rows_kernel(dim3 grid, cudaStream_t s, const float* groups,
                       long long g_b, long long g_r, const float* ymin,
                       long long y_b, const int* g_start, const int* g_n,
                       float* out, int num_tiles, int tile, const Pieces& pc)
{
    const cudaError_t err = allow_smem(rows_kernel<G, SEP_YMIN>,
                                       sizeof(RowsShared));
    if (err != cudaSuccess) return (int)err;
    rows_kernel<G, SEP_YMIN><<<grid, kRowsThreads, sizeof(RowsShared), s>>>(
        groups, g_b, g_r, ymin, y_b, g_start, g_n, out, num_tiles, tile, pc);
    return 0;
}

template <int G>
int launch_rows(dim3 grid, cudaStream_t s, const float* groups,
                long long g_b, long long g_r, const float* ymin,
                long long y_b, const int* g_start, const int* g_n,
                float* out, int num_tiles, int tile, const Pieces& pc)
{
    if (ymin != nullptr) {
        return launch_rows_kernel<G, true>(grid, s, groups, g_b, g_r, ymin,
                                           y_b, g_start, g_n, out,
                                           num_tiles, tile, pc);
    }
    return launch_rows_kernel<G, false>(grid, s, groups, g_b, g_r, ymin,
                                        y_b, g_start, g_n, out, num_tiles,
                                        tile, pc);
}

template <int LINE>
void launch_walk(dim3 grid, cudaStream_t s, const float* soa,
                 long long soa_b, long long soa_r, const int* w_start,
                 const int* w_n, const int* t_start, const int* t_n,
                 long long csr_b, float* out, int num_tiles, int tile,
                 int stride, int chunk, int tail, const Pieces& pc)
{
    // A piece of one chunk stages it once: one ring slot.
    const size_t ring = (pc.piece > 1 ? 2 : 1) * (size_t)max(chunk, tail)
        * kLineFloats * sizeof(float);
    lorentz_walk_kernel<kWalkPoints, LINE>
        <<<grid, tile / kWalkPoints, ring, s>>>(
            soa, soa_b, soa_r, w_start, w_n, t_start, t_n, csr_b, out,
            num_tiles, tile, stride, chunk, tail, pc);
}

int launch_corr(dim3 grid, cudaStream_t s, const float* soa,
                long long soa_b, long long soa_r, const int* w_start,
                const int* w_n, const int* t_start, const int* t_n,
                long long csr_b, float* out, int num_tiles, int tile,
                int stride, int chunk, int tail, const Pieces& pc)
{
    // A piece of one chunk stages it once: one ring slot.
    const size_t lines = (size_t)max(chunk, tail);
    const size_t smem = (pc.piece > 1 ? 2 : 1) * lines * kLineFloats
        * sizeof(float) + sizeof(UnitShared);
    const cudaError_t err = allow_smem(corr_walk_kernel<kWalkPoints>, smem);
    if (err != cudaSuccess) return (int)err;
    corr_walk_kernel<kWalkPoints><<<grid, tile / kWalkPoints, smem, s>>>(
        soa, soa_b, soa_r, w_start, w_n, t_start, t_n, csr_b, out,
        num_tiles, tile, stride, chunk, tail, pc);
    return 0;
}

}  // namespace

extern "C" {

// The piece arguments of pylbl_wings and pylbl_core_segmix: the piece
// list (tile [P]; first, count and slot [T]), the scratch slots per layer,
// K, the scratch [B, num_slots, tile] and the zeroed counters [B, T].
// The grid is (num_pieces, num_layers).
int pylbl_wings(const float* soa, long long soa_b, long long soa_r,
                const int* w_start, const int* w_n, const int* t_start,
                const int* t_n, long long csr_b, float* out, int num_layers,
                int num_tiles, int tile, int stride, int chunk, int tail,
                int line_fn, const int* p_tile, const int* p_first,
                const int* p_count, const int* p_slot, int num_pieces,
                int num_slots, int piece, float* scratch, int* done,
                void* stream)
{
    const dim3 grid(num_pieces, num_layers);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Pieces pc{p_tile, p_first, p_count, p_slot, num_slots, piece,
                    scratch, done};
    if (piece < 1 || tail > kMaxChunk || chunk > kMaxChunk
            || tile > kMaxTile || tile % (32 * kWalkPoints))
        return (int)cudaErrorInvalidValue;
    if (num_pieces > 0 && num_layers > 0) {
        int err = 0;
        switch (line_fn) {
        case kLinePre:
            launch_walk<kLinePre>(grid, s, soa, soa_b, soa_r, w_start, w_n,
                                  t_start, t_n, csr_b, out, num_tiles, tile,
                                  stride, chunk, tail, pc);
            break;
        case kLineRaw:
            launch_walk<kLineRaw>(grid, s, soa, soa_b, soa_r, w_start, w_n,
                                  t_start, t_n, csr_b, out, num_tiles, tile,
                                  stride, chunk, tail, pc);
            break;
        case kLineOwn:
            launch_walk<kLineOwn>(grid, s, soa, soa_b, soa_r, w_start, w_n,
                                  t_start, t_n, csr_b, out, num_tiles, tile,
                                  stride, chunk, tail, pc);
            break;
        case kLineCorr:
            err = launch_corr(grid, s, soa, soa_b, soa_r, w_start, w_n,
                              t_start, t_n, csr_b, out, num_tiles, tile,
                              stride, chunk, tail, pc);
            break;
        default:
            err = (int)cudaErrorInvalidValue;
        }
        if (err != 0) return err;
    }
    return (int)cudaGetLastError();
}

int pylbl_core_segmix(const float* params, long long p_b, long long p_r,
                      const int* tile_start, const int* tile_chunks,
                      float* out, int num_layers, int num_tiles, int tile,
                      int chunk, int seg, const int* p_tile,
                      const int* p_first, const int* p_count,
                      const int* p_slot, int num_pieces, int num_slots,
                      int piece, float* scratch, int* done, void* stream)
{
    if (chunk != kCoreThreads || seg != 32 || tile > kMaxTile || piece < 1)
        return (int)cudaErrorInvalidValue;
    const Pieces pc{p_tile, p_first, p_count, p_slot, num_slots, piece,
                    scratch, done};
    if (num_pieces > 0 && num_layers > 0) {
        const dim3 grid(num_pieces, num_layers);
        core_segmix_kernel<<<grid, kCoreThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
            params, p_b, p_r, tile_start, tile_chunks, out, num_tiles, tile,
            pc);
    }
    return (int)cudaGetLastError();
}

// The stream-ordered chunk list (ops/lineshape_cuda.py SegStreams):
// entry e is chunk ent_chunk[e] of stream ent_stream[e] (= tile * tile/32
// + slot), stream s owns entries stream_ptr[s] .. stream_ptr[s + 1] - 1;
// sums is a [B, max(E, 1), 32] scratch.  Rows 16-byte aligned.  A
// segment core block walks core_piece entries (the wings ignore it).
int pylbl_seg(const float* params, long long p_b, long long p_r,
              const int* ent_chunk, const int* ent_stream, int num_entries,
              const int* stream_ptr, float* sums, float* out, int num_layers,
              int num_tiles, int tile, int chunk, int seg, int kind,
              void* stream, int core_piece)
{
    if (chunk != kCoreThreads || seg != 32 || tile > kMaxTile || tile % 32
            || (kind != kSegCore && kind != kSegWings)
            || (kind == kSegCore && core_piece < 1)
            || reinterpret_cast<uintptr_t>(params) % 16 || p_b % 4
            || p_r % 4)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (num_entries > 0 && num_layers > 0) {
        if (kind == kSegCore) {
            const dim3 grid((num_entries + core_piece - 1) / core_piece,
                            num_layers);
            seg_core_kernel<<<grid, kCoreThreads, 0, s>>>(
                params, p_b, p_r, ent_chunk, num_entries, core_piece, sums);
        } else {
            const dim3 grid((num_entries + kSegWingsWarps - 1)
                            / kSegWingsWarps, num_layers);
            seg_wings_kernel<<<grid, kSegWingsWarps * 32, 0, s>>>(
                params, p_b, p_r, ent_chunk, ent_stream, num_entries, sums);
        }
        const int err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    const int num_points = num_tiles * tile;
    if (num_points > 0 && num_layers > 0) {
        const dim3 grid((num_points + kFoldThreads - 1) / kFoldThreads,
                        num_layers);
        seg_fold_kernel<<<grid, kFoldThreads, 0, s>>>(
            sums, stream_ptr, num_entries, num_points, out);
    }
    return (int)cudaGetLastError();
}

// The piece arguments as pylbl_wings' (K in groups, a multiple of 32);
// groups (and the min-y block) 16-byte aligned with strides of whole
// float4s.
int pylbl_rows(const float* groups, long long g_b, long long g_r,
               const float* ymin, long long y_b, const int* g_start,
               const int* g_n, float* out, int num_layers, int num_tiles,
               int tile, int chunk, const int* p_tile, const int* p_first,
               const int* p_count, const int* p_slot, int num_pieces,
               int num_slots, int piece, float* scratch, int* done,
               void* stream)
{
    if (chunk != kRowsChunk || piece != kRowsPiece
            || reinterpret_cast<uintptr_t>(groups) % 16 || g_b % 4
            || g_r % 4 || reinterpret_cast<uintptr_t>(ymin) % 16 || y_b % 4)
        return (int)cudaErrorInvalidValue;
    const Pieces pc{p_tile, p_first, p_count, p_slot, num_slots, piece,
                    scratch, done};
    if (num_pieces > 0 && num_layers > 0) {
        const dim3 grid(num_pieces, num_layers);
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        int err;
        switch (tile) {
        case 256:
            err = launch_rows<1>(grid, s, groups, g_b, g_r, ymin, y_b,
                                 g_start, g_n, out, num_tiles, tile, pc);
            break;
        case 512:
            err = launch_rows<2>(grid, s, groups, g_b, g_r, ymin, y_b,
                                 g_start, g_n, out, num_tiles, tile, pc);
            break;
        case 1024:
            err = launch_rows<4>(grid, s, groups, g_b, g_r, ymin, y_b,
                                 g_start, g_n, out, num_tiles, tile, pc);
            break;
        default:
            return (int)cudaErrorInvalidValue;
        }
        if (err != 0) return err;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
