// Pair forces over the padded cell-major layout, for Hopper (sm_90a).
//
// Replaces: obmd_tpu/forces/pallas_dpd.py make_pair_kernel, both of its
// bodies — kernel_bigtile (:575-797, fill cap <= 20) and the rank-looped
// kernel (:324-559, fill cap > 20) — through the entry point obmd_pair, and
// the legacy full-stencil make_dpd_kernel (:877-1112, body :909) through
// obmd_dpd_full.  They compute one function; the two entry points differ
// only in the r and cutoff arithmetic each TPU kernel uses (make_pair_kernel:
// r = r^2 * rsqrt(r^2), r^2 > 1e-20; make_dpd_kernel: r = sqrt(r^2),
// r > 1e-10).  One template serves both, for each law (dpd, lj; ljrf and
// 1-4 types through obmd_pair only, as make_dpd_kernel has neither).
//
// Layout (the TPU kernels' calling convention): fld f32[nb][NF][cap][lanes]
// with channels x, y, z, vx, vy, vz (dead slots at x = y = z = BIG), then
// for the ljrf law the charge q (channel 6), then with 2-4 types the type
// as a float (channel NF - 1; pallas_dpd.py:273-276), so NF = 6, 7 or 8;
// tag i32[nb][cap][lanes], occ i32[nb] (highest occupied rank + 1 per
// block), optional pbond i32[nb][n_excl][cap][lanes] (the tags of each
// slot's bond partners, -2 for none, n_excl = 2 for chains and 4 for
// branched topologies; 1-2 exclusion: a pair (i, j) is dropped when j's tag
// is one of i's partner tags — make_pair_kernel's exclusion channels,
// :380-381 and :625-643, and make_dpd_kernel's at n_excl = 2, :968-972),
// out f32[nb][3][cap][lanes].  Slot (b, r, l)
// holds rank r of the cell at lane l of block b; lane l covers x-slab
// b*p + l/s and the (y, z) cell l % s.  With p == 1 the lanes are padded to
// a multiple of 128 and lanes s..lanes-1 are never filed.
//
// Laws: dpd and lj as pair_kernel.py states them (dpd/tstat is the dpd law
// with a0 = 0, pallas_dpd.py:243-248); ljrf (pallas_dpd.py
// :398-409, pair_lj_cut_rf.cpp:118-131) adds to the lj force, for
// r^2 < rc_coul^2 and independently of the LJ cutoff, the reaction field
// qq*qi*qj*(rinv^3 - c_rf/rc_coul^3) with rinv = rsqrt(r^2) and c_rf =
// 2(eps_rf - 1)/(2 eps_rf + 1).  With types (or the ljrf law) every
// coefficient — the cutoff, 1/cut, a0, gamma, sigma, lj1, lj2, c_rf — is a
// per-type-pair table of float32 values indexed by ti*T + tj (the TPU
// kernel's T^2 one-hot blend of the same values), staged in shared memory;
// a pair is first tested against the largest cutoff, then the law applies
// its own per-pair cutoffs.  The type channel holds small integers, exact
// in float32, so the truncating conversion reads them exactly.  A dead j
// slot is rejected before any q or type read.
//
// Design.  Newton-off: each live atom i sums F_ij over every live atom
// filed in the stencil's cells around its own FILED cell (27 where every
// axis has >= 3 cells), in the stencil's order (ox, then oy, then oz,
// pair_kernel.neighbor_offsets) and, within a cell, in ascending rank, so
// there are no atomics and no cross-block reaction pass (the Newton
// kernel's out2 shift), and the sums are the thread-per-slot kernel's (the
// first design both bodies replaced), less its dead slots.  The self pair
// is skipped by slot.  Two bodies compute this; the tile plan
// (forces/pair_kernel.TilePlan.of(geom)) picks one from the geometry's fill
// cap, and the launch's shared-memory figure must match the body's layout.
//
// The tiled body (fill cap <= 128, a block's threads; pair_kernel):  one
// CUDA block takes one tile of cells, a tx x ty x tz box of the grid
// chosen so that its staged stencil fits the shared-memory budget with
// every cell at the storage cap, and runs in three steps:
//  1. it stages its tile's stencil, the box one cell wider on each side
//     (the whole axis where that box would wrap onto itself), each cell
//     once: a pass over (rank, cell) with the cell fastest reads x of
//     every rank below occ of the cell's block (neighbouring threads on
//     neighbouring lanes, so the reads coalesce along z) and sets the
//     rank's bit in the cell's live mask; a second pass writes each live
//     rank's (x, y, z, rank) as one float4 at the cell's start plus the
//     live ranks below it (a popcount of the mask), so each cell's live
//     atoms sit compacted in ascending rank;
//  2. threads take the tile's live atoms, one atom each, in 32-atom
//     chunks (a warp's worth) over the tile's cells in order, so a warp
//     mostly walks the same cells' lists; a chunk goes to block part
//     chunk % split (split > 1 where the grid has few tiles: the 7 x 1 x 1
//     box's 7 cells run on 28 blocks, not 7);
//  3. each thread walks the live atoms of its atom's stencil cells; v, q,
//     the type and the tag of a j within the cutoff are read by slot
//     through L1; x, y and z of every candidate come from shared memory.
// Every slot of the output is written once: a live i by its thread, a
// dead rank of a tile cell by block part 0 while staging, the padding
// lanes (slabs past nx, lanes past p * s) by a grid-stride loop.
// Shared memory, per staged cell: cap float4s (16 B each), five ints (the
// block, the lane, the ranks to read, the live count, a tile-cell flag)
// and ceil(cap / 32) mask words; plus (tile cells + 1) ints of the tile's
// prefix; at most 100 KB (SMEM_BUDGET) so that two blocks fit an SM.
//
// The dense body (fill cap > 128: path I's and K's water, ~100 atoms a
// cell at cap 150), where a tile would be one cell staging 27 cells at the
// storage cap (66 KB: 3 blocks, 12 warps an SM) and a thread's j reads of
// q, type and tag by slot would be three dependent trips to L2 per pair.
// Two kernels in one C call:
//  1. dense_compact files the pad layout into cell-major record runs in
//     device memory (scratch the wrapper allocates): each cell's live atoms
//     in ascending rank, 32 bytes each (x, y, z, q; tag, type, rank), and
//     each cell's count; it writes the zero force of every dead rank and
//     padding lane;
//  2. pair_dense: one block a cell, one thread a live atom of it (the
//     atoms ordered by z, so that a warp's atoms share a slab of the
//     cell).  Thread 0 streams the stencil's runs through a ring of three
//     slots with cp.async.bulk, each completing on its slot's mbarrier, so
//     every value the candidate loop reads (x, y, z, q, type, tag) is in
//     shared memory and the next runs load while a run is consumed.  For
//     each run a warp first tests the candidates, 8 at a time, into one
//     bit a candidate per thread, then each thread runs the law on its own
//     bits in ascending rank: the warp runs the law as often as its
//     busiest thread has pairs, where the tiled body runs it for every
//     candidate any thread has within the cutoff.  Resident blocks are
//     set by registers (at most 64, 8 blocks an SM: the water's 972 cells
//     in one wave).  The image on a periodic axis is the j cell's shift,
//     subtracted from the plain difference: a run wraps an atom across a
//     face every step but refiles it only at a relayout, so dense_compact
//     writes each atom's record in its filed cell's frame (less the box
//     length where the atom lies more than half a box from its cell), and
//     the shift is then every pair's minimum image.  An atom within its
//     cell's frame keeps its coordinates, so on such an input the two
//     bodies give the same bytes (the law's arithmetic is the tiled
//     body's).  It is instantiated for the dense rows' launch only (ljrf,
//     types, two exclusion channels, no noise, y and z periodic with >= 3
//     cells; pair_kernel.DENSE_BUILT); TilePlan.of gives every other
//     launch the tiled body.
// Neither body uses float atomics, so two launches on one input give the
// same bytes.
//
// Axes: x is open (neighbour slabs outside [0, nx) are skipped) or
// periodic with >= 3 cells (the slab index wraps); y and z are periodic
// with >= 3 cells (the cell index wraps), or, in the tiled body's
// instantiations with the geometry flags, periodic with a single cell or
// open:
//  - kOneCell (pallas_dpd.py:316-322): a periodic axis shorter than 3 cut +
//    skin widths is one cell, its own neighbour on both sides, so only the
//    offset 0 is visited on it (the wrapped -1 and +1 would count each
//    pair three times) and the minimum image picks the pair's nearest
//    image; the wrapper refuses such an axis shorter than twice the
//    cutoff, where a second image could lie within it;
//  - kOpen (pallas_dpd.py:227-228, :511-515): an open y or z axis has no
//    image: a neighbour cell outside [0, n) is skipped and that axis takes
//    no minimum image (make_pair_kernel only; make_dpd_kernel has no open
//    y/z, and its entry point refuses it).
// So the visited cells are distinct and the minimum image is applied per
// pair on every periodic axis.  A dead slot is never staged: it is told by
// its x against BIG/2, not by distance, since the minimum image on x folds
// BIG back into the box.  The staging reads ranks below occ of the
// cell's block only (occ may be stale-high, never stale-low).  The pair
// noise is the reference's counter hash of (salt, smaller tag, larger
// tag), bit for bit.
// Exclusion: each thread loads its atom's kExcl partner tags (2 or 4, a
// template parameter, so the loads and compares unroll and the tags stay
// in registers) once and skips an in-cutoff j whose tag equals one.
// Newton-off visits every pair
// from both ends and each end checks only its own partners; that equals
// the TPU kernels' one-sided check because partner lists are symmetric
// (state.init_state builds both directions of every bond).  -2 matches no
// tag (live tags are >= 1; a dead slot's stale tag is never read).
// The tiled body instantiates four channels for every law, type flag,
// noise variant and y/z geometry of make_pair_kernel (make_dpd_kernel has
// two); the dense body, the dense rows' two.
// The channel count, the law and the type tables are template parameters,
// so a 6-channel one-type launch compiles none of them.  So are the DPD
// law's two variants, instantiated for obmd_pair's dpd law only
// (make_dpd_kernel has neither):
//  - gaussian noise (pallas_dpd.py:431-443, :690-696): a second hash
//    h2 = fmix32(h ^ 0x7F4A7C15), u2 from its top 24 bits, and noise =
//    sqrt(-2 ln max(u1, 1e-12)) cos(2 pi u2) in place of sqrt(3)(2 u1 - 1),
//    with the accurate logf, sqrtf and cosf (no fast-math intrinsics), so
//    the draws stay within a few ulp of XLA's;
//  - the dpd/tstat temperature ramp (:236-248, :449-451, :849-853): the
//    noise term times the runtime scalar sig_scale = sqrt(T(step)/t_start)
//    from Params, computed on the host per step beside the salt.
// A constant-T or uniform launch compiles neither.
//
// Bound on an H100: the work is the candidate-pair distance tests plus the
// in-cutoff force evaluations of the pairs not excluded, each unordered
// pair once; chip_smoke.py counts both, and the bytes, from its run's
// inputs.  Both bodies do each pair twice (Newton-off) and are bound by
// their candidate loops.  The tiled body reads each candidate from shared
// memory at a few addresses per warp (one per cell its lanes are in), and
// a warp runs the law for its lanes that found a pair while the others
// wait: per-lane queues of pairs that let the whole warp take the law at
// once ran slower on the card (PERF.md §6).  The dense body tests each
// candidate with one broadcast shared-memory read and ~10 instructions (no
// rounding for the image) and runs the law as often as a warp's busiest
// thread has pairs in the run: on the water's ~2,750
// candidates an atom (~11% within the cutoff) the law takes a large share
// of the instruction slots; packing the warp's pairs onto all lanes would need
// queues that take the shared memory of the eighth block an SM.
// chip_smoke.py reports each body's time against the bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kBigHalf = 0.5e8f;
constexpr float kEps = 1.0e-10f;
constexpr float kEps2 = 1.0e-20f;
constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kTwoPi = 6.2831855f;      // float32(2 pi), as the TPU kernel
constexpr int kThreads = 128;             // pair_kernel.THREADS
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the most dynamic shared memory a block may take on an H100 (227 KB),
// less the static coefficient table and a reserve
constexpr int kSmemMax = 232448 - 1024;

enum Law { kDpd = 0, kLj = 1, kLjrf = 2 };

}  // namespace

// The launch parameters and tables cross the source's translation units
// (OBMD_PAIR_PART, at the end), so they live in a named namespace.
namespace obmd_pair_detail {

struct Params {
  int nb, cap, lanes, nx, ny, nz, s, p, per_x;
  float lx, ly, lz, inv_lx, inv_ly, inv_lz;
  float a0, gamma, sigma, cut, inv_cut, dtinvsqrt, lj1, lj2;
  uint32_t salt;
  float sig_scale;                 // read by the ramp instantiations only
  int per_y, per_z;                // read by the kOpen instantiations only
  int tile_x, tile_y, tile_z;      // the tile plan: cells per tile on x, y, z
  int split;                       // blocks per tile
  int smem;                        // dynamic shared memory bytes per block
};

// The launch's host-side parameters: the kernels' Params, which the tiled
// body's instantiations keep as they were, and the plan's body.
struct Launch : Params {
  int dense;                       // the plan's body: 1 the dense body
  void* scratch;                   // the dense body's records and counts
  float lo_x, lo_y, lo_z;          // the grid's origin (the records' frames)
};

// The per-type-pair coefficient tables (row-major [kRows][T*T], T <= 4)
// and the law's scalars, read only by the typed instantiations.
constexpr int kMaxPairs = 16;
enum TabRow { kCut2 = 0, kInvCut, kA0, kGamma, kSigma, kLj1, kLj2, kCrf,
              kRows };
struct Tables {
  int ntypes;
  float cut2_max, qq, cut_coul2, inv_rc3;
  float v[kRows * kMaxPairs];
};

}  // namespace obmd_pair_detail

namespace {

using namespace obmd_pair_detail;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// The shared memory a block takes (TilePlan.smem_bytes): the largest
// staged stencil, min(t + 2, n) cells on each axis, at cap ranks each.
__host__ __device__ inline int staged_max(const Params& P) {
  return imin(P.tile_x + 2, P.nx) * imin(P.tile_y + 2, P.ny)
         * imin(P.tile_z + 2, P.nz);
}
__host__ __device__ inline long long smem_bytes(const Params& P) {
  const long long cells = staged_max(P);
  const long long words = (P.cap + 31) / 32;
  return cells * P.cap * 16 + cells * 5 * 4 + cells * words * 4
         + (long long)(P.tile_x * P.tile_y * P.tile_z + 1) * 4;
}

// One axis of a tile's staged stencil: grid cells start, start + 1, ...,
// start + len - 1 (wrapping on a periodic axis), each once.
struct Span {
  int n, start, len;
  bool per;
};

__device__ __forceinline__ Span span_of(int t0, int t, int n, bool per) {
  const int te = min(t, n - t0);
  Span a{n, 0, n, per};
  if (per) {
    if (te + 2 < n) {
      a.start = (t0 - 1 + n) % n;
      a.len = te + 2;
    }
  } else {
    a.start = max(t0 - 1, 0);
    a.len = min(t0 + te + 1, n) - a.start;
  }
  return a;
}

// staged index of grid cell j (j lies in the span) and back
__device__ __forceinline__ int local_of(const Span& a, int j) {
  const int l = j - a.start;
  return (a.per && l < 0) ? l + a.n : l;
}
__device__ __forceinline__ int grid_of(const Span& a, int l) {
  const int j = a.start + l;
  return j >= a.n ? j - a.n : j;
}

// staged index of grid cell (jx, jy, jz), which lies in the staged stencil
__device__ __forceinline__ int staged_index(const Span& sx, const Span& sy,
                                            const Span& sz, int jx, int jy,
                                            int jz) {
  return (local_of(sx, jx) * sy.len + local_of(sy, jy)) * sz.len
         + local_of(sz, jz);
}

template <int kLaw, bool kLegacy, int kExcl, bool kTypes, bool kGauss,
          bool kRamp, bool kOneCell, bool kOpen>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const float* __restrict__ fld, const int* __restrict__ tag,
            const int* __restrict__ occ, const int* __restrict__ pbond,
            float* __restrict__ out, Params P, const Tables T) {
  // channels: x, y, z, vx, vy, vz [, q] [, type]
  constexpr bool kTyped = kTypes || kLaw == kLjrf;
  constexpr int kNf = 6 + (kLaw == kLjrf) + kTypes;
  constexpr int kChQ = 6;
  constexpr int kChT = kNf - 1;
  __shared__ float tab[kTyped ? kRows * kMaxPairs : 1];
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x;
  const int cap = P.cap;
  const int words = (cap + 31) >> 5;
  const size_t plane = (size_t)cap * P.lanes;
  if constexpr (kTyped) {
    for (int k = tid; k < kRows * kMaxPairs; k += kThreads) tab[k] = T.v[k];
  }

  // the padding lanes of every (block, rank) row get no force
  {
    const int nblk = gridDim.x * gridDim.y;
    for (int q = blockIdx.y * gridDim.x + blockIdx.x; q < P.nb * cap;
         q += nblk) {
      const int b = q / cap, r = q % cap;
      const int lp = min(P.nx - b * P.p, P.p) * P.s;
      float* fo = out + (size_t)b * 3 * plane + (size_t)r * P.lanes;
      for (int l = lp + tid; l < P.lanes; l += kThreads) {
        fo[l] = 0.f;
        fo[plane + l] = 0.f;
        fo[2 * plane + l] = 0.f;
      }
    }
  }

  // this block's tile and its staged stencil
  const int ntz = (P.nz + P.tile_z - 1) / P.tile_z;
  const int nty = (P.ny + P.tile_y - 1) / P.tile_y;
  const int tz0 = (blockIdx.x % ntz) * P.tile_z;
  const int ty0 = (blockIdx.x / ntz % nty) * P.tile_y;
  const int tx0 = blockIdx.x / (ntz * nty) * P.tile_x;
  const int part = blockIdx.y;
  const int tex = min(P.tile_x, P.nx - tx0);
  const int tey = min(P.tile_y, P.ny - ty0);
  const int tez = min(P.tile_z, P.nz - tz0);
  const int ntc = tex * tey * tez;
  const Span sx = span_of(tx0, P.tile_x, P.nx, P.per_x != 0);
  const Span sy = span_of(ty0, P.tile_y, P.ny, !kOpen || P.per_y);
  const Span sz = span_of(tz0, P.tile_z, P.nz, !kOpen || P.per_z);
  const int nst = sx.len * sy.len * sz.len;
  const int smax = staged_max(P);
  float4* atom = smem;                         // [smax][cap]
  int* cblk = reinterpret_cast<int*>(smem + (size_t)smax * cap);
  int* clane = cblk + smax;
  int* cread = clane + smax;                   // ranks to read: min(occ, cap)
  int* ccnt = cread + smax;                    // live atoms
  int* ctile = ccnt + smax;                    // a cell of the tile
  unsigned* mask = reinterpret_cast<unsigned*>(ctile + smax);  // [smax][words]
  int* toff = reinterpret_cast<int*>(mask + (size_t)smax * words);

  for (int c = tid; c < nst; c += kThreads) {
    const int jx = grid_of(sx, c / (sz.len * sy.len));
    const int jy = grid_of(sy, c / sz.len % sy.len);
    const int jz = grid_of(sz, c % sz.len);
    const int bj = jx / P.p;
    cblk[c] = bj;
    clane[c] = (jx % P.p) * P.s + jy * P.nz + jz;
    cread[c] = min(occ[bj], cap);
    ctile[c] = jx >= tx0 && jx < tx0 + tex && jy >= ty0 && jy < ty0 + tey
               && jz >= tz0 && jz < tz0 + tez;
  }
  for (int k = tid; k < nst * words; k += kThreads) mask[k] = 0u;
  __syncthreads();
  // pass 1: the live masks; a dead rank of a tile cell gets no force
  for (int e = tid; e < nst * cap; e += kThreads) {
    const int c = e % nst, r = e / nst;
    const size_t row = (size_t)r * P.lanes + clane[c];
    const bool live = r < cread[c]
        && fld[(size_t)cblk[c] * kNf * plane + row] < kBigHalf;
    if (live) {
      atomicOr(&mask[c * words + (r >> 5)], 1u << (r & 31));
    } else if (ctile[c] && part == 0) {
      float* fo = out + (size_t)cblk[c] * 3 * plane + row;
      fo[0] = 0.f;
      fo[plane] = 0.f;
      fo[2 * plane] = 0.f;
    }
  }
  __syncthreads();
  for (int c = tid; c < nst; c += kThreads) {
    int n = 0;
    for (int w = 0; w < words; ++w) n += __popc(mask[c * words + w]);
    ccnt[c] = n;
  }
  __syncthreads();
  // pass 2: each live rank's x, y, z at its compacted place; meanwhile
  // warp 0 sums the tile cells' counts (toff[k] = atoms before tile cell k)
  for (int e = tid; e < nst * cap; e += kThreads) {
    const int c = e % nst, r = e / nst;
    const unsigned* m = mask + c * words;
    const unsigned bit = 1u << (r & 31);
    if (!(m[r >> 5] & bit)) continue;
    int pos = __popc(m[r >> 5] & (bit - 1u));
    for (int w = 0; w < (r >> 5); ++w) pos += __popc(m[w]);
    const float* f = fld + (size_t)cblk[c] * kNf * plane
                     + (size_t)r * P.lanes + clane[c];
    atom[(size_t)c * cap + pos] =
        make_float4(f[0], f[plane], f[2 * plane], __int_as_float(r));
  }
  if (tid < 32) {
    int run = 0;
    for (int k0 = 0; k0 < ntc; k0 += 32) {
      const int k = k0 + tid;
      int v = k < ntc ? ccnt[staged_index(sx, sy, sz, tx0 + k / (tez * tey),
                                          ty0 + k / tez % tey,
                                          tz0 + k % tez)]
                      : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, v, d);
        if (tid >= d) v += u;
      }
      if (k < ntc) toff[k + 1] = run + v;
      run += __shfl_sync(kFull, v, 31);
    }
    if (tid == 0) toff[0] = 0;
  }
  __syncthreads();

  const float cut2 = kTyped ? T.cut2_max : P.cut * P.cut;
  const int natoms = toff[ntc];
  const int nchunks = (natoms + 31) >> 5;
  for (int m = 0;; ++m) {
    const int chunk = (m * kWarps + (tid >> 5)) * P.split + part;
    const int a = (chunk << 5) + (tid & 31);
    if (chunk >= nchunks || a >= natoms) break;
    int k = 0, kh = ntc;                       // toff[k] <= a < toff[kh]
    while (kh - k > 1) {
      const int mid = (k + kh) >> 1;
      if (toff[mid] <= a) k = mid; else kh = mid;
    }
    const int cx = tx0 + k / (tez * tey);
    const int cy = ty0 + k / tez % tey;
    const int cz = tz0 + k % tez;
    const int ci = staged_index(sx, sy, sz, cx, cy, cz);
    const float4 ai = atom[(size_t)ci * cap + (a - toff[k])];
    const int ri = __float_as_int(ai.w);
    const int bi = cblk[ci];
    const size_t row = (size_t)ri * P.lanes + clane[ci];
    const float* fi = fld + (size_t)bi * kNf * plane + row;
    const float xi = ai.x, yi = ai.y, zi = ai.z;
    float fx = 0.f, fy = 0.f, fz = 0.f;
    float vxi = 0.f, vyi = 0.f, vzi = 0.f;
    int ti = 0;
    if (kLaw == kDpd) {
      vxi = fi[3 * plane];
      vyi = fi[4 * plane];
      vzi = fi[5 * plane];
      ti = tag[(size_t)bi * plane + row];
    }
    float qi = 0.f;
    if constexpr (kLaw == kLjrf) qi = fi[kChQ * plane];
    int tbase = 0;                       // ti * T: the row of i's type
    if constexpr (kTypes) tbase = (int)fi[kChT * plane] * T.ntypes;
    int pt[4] = {-2, -2, -2, -2};          // the partner tags
    if constexpr (kExcl > 0) {
      const int* pb = pbond + (size_t)bi * kExcl * plane + row;
#pragma unroll
      for (int c = 0; c < kExcl; ++c) pt[c] = pb[c * plane];
    }
    for (int ox = -1; ox <= 1; ++ox) {
      int jx = cx + ox;
      if (P.per_x) {
        jx = (jx + P.nx) % P.nx;
      } else if (jx < 0 || jx >= P.nx) {
        continue;
      }
      for (int oy = -1; oy <= 1; ++oy) {
        if constexpr (kOneCell) {
          if (P.ny == 1 && oy != 0) continue;
        }
        int jy;
        if constexpr (kOpen) {
          jy = cy + oy;
          if (P.per_y) {
            jy = (jy + P.ny) % P.ny;
          } else if (jy < 0 || jy >= P.ny) {
            continue;
          }
        } else {
          jy = (cy + oy + P.ny) % P.ny;
        }
        for (int oz = -1; oz <= 1; ++oz) {
          if constexpr (kOneCell) {
            if (P.nz == 1 && oz != 0) continue;
          }
          int jz;
          if constexpr (kOpen) {
            jz = cz + oz;
            if (P.per_z) {
              jz = (jz + P.nz) % P.nz;
            } else if (jz < 0 || jz >= P.nz) {
              continue;
            }
          } else {
            jz = (cz + oz + P.nz) % P.nz;
          }
          const int c = staged_index(sx, sy, sz, jx, jy, jz);
          const float4* aj = atom + (size_t)c * cap;
          const int nj = ccnt[c];
          const int self_r = c == ci ? ri : -1;
          const float* fj = fld + (size_t)cblk[c] * kNf * plane + clane[c];
          const int* tj = tag + (size_t)cblk[c] * plane + clane[c];
          for (int q = 0; q < nj; ++q) {
            const float4 b = aj[q];
            const int rj = __float_as_int(b.w);
            if (rj == self_r) continue;
            float dx = xi - b.x;
            float dy = yi - b.y;
            float dz = zi - b.z;
            if (P.per_x) dx = dx - P.lx * rintf(dx * P.inv_lx);
            if (!kOpen || P.per_y) dy = dy - P.ly * rintf(dy * P.inv_ly);
            if (!kOpen || P.per_z) dz = dz - P.lz * rintf(dz * P.inv_lz);
            const float rsq = dx * dx + dy * dy + dz * dz;
            if (!(rsq < cut2)) continue;
            const size_t o = (size_t)rj * P.lanes;
            if constexpr (kExcl == 2) {
              const int tjx = tj[o];
              if (tjx == pt[0] || tjx == pt[1]) continue;
            } else if constexpr (kExcl == 4) {
              const int tjx = tj[o];
              if (tjx == pt[0] || tjx == pt[1] || tjx == pt[2]
                  || tjx == pt[3])
                continue;
            }
            float rr = 0.f;
            if (kLegacy) {
              rr = sqrtf(rsq);
              if (!(rr > kEps)) continue;
            } else if (!(rsq > kEps2)) {
              continue;
            }
            int tp = 0;                    // the type pair's table column
            if constexpr (kTypes) tp = tbase + (int)fj[kChT * plane + o];
            float fpair;
            if constexpr (kLaw == kLj && !kTyped) {
              const float r2inv = 1.f / rsq;
              const float r6inv = r2inv * r2inv * r2inv;
              fpair = r6inv * (P.lj1 * r6inv - P.lj2) * r2inv;
            } else if constexpr (kLaw != kDpd) {
              fpair = 0.f;
              if (rsq < tab[kCut2 * kMaxPairs + tp]) {
                const float r2inv = 1.f / rsq;
                const float r6inv = r2inv * r2inv * r2inv;
                fpair = r6inv * (tab[kLj1 * kMaxPairs + tp] * r6inv
                                 - tab[kLj2 * kMaxPairs + tp]) * r2inv;
              }
              if constexpr (kLaw == kLjrf) {
                if (rsq < T.cut_coul2) {
                  const float rinv = rsqrtf(rsq);
                  const float r2i = rinv * rinv;
                  const float qprod = T.qq * qi * fj[kChQ * plane + o];
                  fpair += qprod * (r2i * rinv
                                    - T.inv_rc3 * tab[kCrf * kMaxPairs + tp]);
                }
              }
            } else {
              float a0 = P.a0, gamma = P.gamma, sigma = P.sigma;
              float inv_cut = P.inv_cut;
              if constexpr (kTyped) {
                if (!(rsq < tab[kCut2 * kMaxPairs + tp])) continue;
                a0 = tab[kA0 * kMaxPairs + tp];
                gamma = tab[kGamma * kMaxPairs + tp];
                sigma = tab[kSigma * kMaxPairs + tp];
                inv_cut = tab[kInvCut * kMaxPairs + tp];
              }
              const float rinv = rsqrtf(rsq);
              if (!kLegacy) rr = rsq * rinv;
              const float wd = 1.f - rr * inv_cut;
              const float dot = dx * (vxi - fj[3 * plane + o])
                              + dy * (vyi - fj[4 * plane + o])
                              + dz * (vzi - fj[5 * plane + o]);
              const int tjv = tj[o];
              const uint32_t lo = (uint32_t)min(ti, tjv);
              const uint32_t hi = (uint32_t)max(ti, tjv);
              const uint32_t h = fmix32((lo * 0x9E3779B9u)
                                        ^ (hi * 0x85EBCA77u) ^ P.salt);
              const float u01 = (float)(h >> 8) * (1.0f / 16777216.0f);
              float noise;
              if constexpr (kGauss) {
                const uint32_t h2 = fmix32(h ^ 0x7F4A7C15u);
                const float u2 = (float)(h2 >> 8) * (1.0f / 16777216.0f);
                noise = sqrtf(-2.f * logf(fmaxf(u01, 1e-12f)))
                        * cosf(kTwoPi * u2);
              } else {
                noise = kSqrt3 * (2.f * u01 - 1.f);
              }
              fpair = a0 * wd;
              fpair = fpair - gamma * wd * wd * dot * rinv;
              if constexpr (kRamp) {
                fpair = fpair
                        + sigma * wd * noise * P.dtinvsqrt * P.sig_scale;
              } else {
                fpair = fpair + sigma * wd * noise * P.dtinvsqrt;
              }
              fpair = fpair * rinv;
            }
            fx += fpair * dx;
            fy += fpair * dy;
            fz += fpair * dz;
          }
        }
      }
    }
    float* fo = out + (size_t)bi * 3 * plane + row;
    fo[0] = fx;
    fo[plane] = fy;
    fo[2 * plane] = fz;
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed, once per
// kernel and size (`allowed`: the kernel's largest size allowed so far).
template <typename K>
int allow_smem(K* kern, const Params& P, int& allowed) {
  if (P.smem <= allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
  if (e != cudaSuccess) return (int)e;
  allowed = P.smem;
  return 0;
}

template <int kLaw, bool kLegacy, int kExcl, bool kTypes, bool kGauss,
          bool kRamp, bool kOneCell, bool kOpen>
int start_geo(const dim3& grid, cudaStream_t st, const void* fld,
              const void* tag, const void* occ, const void* pbond,
              void* out, const Launch& P, const Tables& T) {
  auto* kern = pair_kernel<kLaw, kLegacy, kExcl, kTypes, kGauss, kRamp,
                           kOneCell, kOpen>;
  static int allowed = 48 * 1024;
  if (const int e = allow_smem(kern, P, allowed)) return e;
  kern<<<grid, kThreads, P.smem, st>>>((const float*)fld, (const int*)tag,
                                       (const int*)occ, (const int*)pbond,
                                       (float*)out, P, T);
  return 0;
}

// The geometry flags at run time -> the instantiation: a single-cell y or
// z axis, an open y or z axis (make_pair_kernel's only).
template <int kLaw, bool kLegacy, int kExcl, bool kTypes, bool kGauss,
          bool kRamp>
int start(const dim3& grid, cudaStream_t st, const void* fld,
          const void* tag, const void* occ, const void* pbond, void* out,
          const Launch& P, const Tables& T) {
  const bool one_cell = P.ny == 1 || P.nz == 1;
  const bool open = !(P.per_y && P.per_z);
  if (!one_cell && !open) {
    return start_geo<kLaw, kLegacy, kExcl, kTypes, kGauss, kRamp, false,
                     false>(grid, st, fld, tag, occ, pbond, out, P, T);
  } else if (!open) {
    return start_geo<kLaw, kLegacy, kExcl, kTypes, kGauss, kRamp, true,
                     false>(grid, st, fld, tag, occ, pbond, out, P, T);
  } else if constexpr (kLegacy) {
    return (int)cudaErrorInvalidValue;    // make_dpd_kernel has no open y/z
  } else if (!one_cell) {
    return start_geo<kLaw, kLegacy, kExcl, kTypes, kGauss, kRamp, false,
                     true>(grid, st, fld, tag, occ, pbond, out, P, T);
  } else {
    return start_geo<kLaw, kLegacy, kExcl, kTypes, kGauss, kRamp, true,
                     true>(grid, st, fld, tag, occ, pbond, out, P, T);
  }
}

// The noise flags at run time -> the instantiation: gaussian noise and the
// ramp exist for make_pair_kernel's dpd law only.
template <int kLaw, bool kLegacy, int kExcl, bool kTypes>
int start_noise(const dim3& grid, cudaStream_t st, const void* fld,
                const void* tag, const void* occ, const void* pbond,
                void* out, bool gauss, bool ramp, const Launch& P,
                const Tables& T) {
  if (!gauss && !ramp) {
    return start<kLaw, kLegacy, kExcl, kTypes, false, false>(
        grid, st, fld, tag, occ, pbond, out, P, T);
  } else if constexpr (kLaw != kDpd || kLegacy) {
    return (int)cudaErrorInvalidValue;
  } else if (gauss && ramp) {
    return start<kLaw, kLegacy, kExcl, kTypes, true, true>(
        grid, st, fld, tag, occ, pbond, out, P, T);
  } else if (gauss) {
    return start<kLaw, kLegacy, kExcl, kTypes, true, false>(
        grid, st, fld, tag, occ, pbond, out, P, T);
  } else {
    return start<kLaw, kLegacy, kExcl, kTypes, false, true>(
        grid, st, fld, tag, occ, pbond, out, P, T);
  }
}

// ---------------------------------------------------------------------------
// The dense body (TilePlan.dense: a cell's fill cap above a block's threads)
// ---------------------------------------------------------------------------

constexpr int kRing = 3;         // j cells in flight (pair_kernel.DENSE_RING)
constexpr int kCompactWarps = 8;  // the compaction pass's warps a block
// The body's blocks an SM: at most 64 registers a thread, so that the water
// row's 972 cells run in one wave of 132 x 8 blocks.
constexpr int kDenseMinBlocks = 8;

// A cell's record run: ranks at stride 8 (cp.async.bulk moves 16-byte
// multiples; the test loop reads 8 candidates at a time).
__host__ __device__ inline int dense_capr(int cap) { return (cap + 7) & ~7; }
__host__ __device__ inline int dense_words(int cap) {
  return (dense_capr(cap) + 31) >> 5;
}
// A coordinate on a periodic axis of n cells from lo, in the frame of its
// filed cell c: less the box length times the nearest integer to its
// distance from the cell's centre over the box length.  A coordinate
// within half a box of the centre comes back unchanged.
__device__ __forceinline__ float in_cell_frame(float v, int c, int n,
                                               float len, float inv_len,
                                               float lo) {
  const float centre = lo + (c + 0.5f) * (len / n);
  return v - len * rintf((v - centre) * inv_len);
}

// TilePlan.smem_bytes of a dense plan: the ring of kRing record runs of 32
// bytes an atom, each thread's candidate masks of one run, and the cell's
// z and its atoms' order by z (8 bytes an atom of a run)
__host__ __device__ inline long long dense_smem(int cap) {
  return (long long)kRing * dense_capr(cap) * 32
         + (long long)dense_words(cap) * kThreads * 4
         + (long long)dense_capr(cap) * 8;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// one arrival that also expects `bytes` of copies to complete the phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// a bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Pass 1 of the dense body: the pad layout -> cell-major records.  Block
// (x, b) takes 32 lanes of layout block b, its warps every 8th rank.  Each
// live rank (below min(occ, cap), x below BIG/2) sets its bit in its lane's
// mask; each dead rank and every rank of a padding lane gets a zero force
// (the body writes the live ones, so every slot is written once).  Then
// each live rank writes its record at its cell's run plus the live ranks
// below it, so a run holds the cell's live atoms in ascending rank: x, y, z
// (in the cell's frame on each periodic axis, in_cell_frame), q (0 without
// charges), then the tag, the type (0 with one type) and the rank as ints.
// A cell's count goes to cnt.
template <int kNf, bool kQ, bool kTypes>
__global__ void __launch_bounds__(kCompactWarps * 32)
dense_compact(const float* __restrict__ fld, const int* __restrict__ tag,
              const int* __restrict__ occ, float* __restrict__ out,
              float4* __restrict__ rec, int* __restrict__ cnt, Params P,
              float lo_x, float lo_y, float lo_z) {
  extern __shared__ unsigned cmask[];          // [words][32]
  const int l = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int lane = blockIdx.x * 32 + l;
  const int cap = P.cap, words = (cap + 31) >> 5;
  const size_t plane = (size_t)cap * P.lanes;
  const bool real = lane < min(P.nx - b * P.p, P.p) * P.s;
  const int cread = min(occ[b], cap);
  for (int k = threadIdx.x; k < words * 32; k += blockDim.x) cmask[k] = 0u;
  __syncthreads();
  const float* f = fld + (size_t)b * kNf * plane + lane;
  if (lane < P.lanes) {
    float* fo = out + (size_t)b * 3 * plane + lane;
    for (int r = warp; r < cap; r += kCompactWarps) {
      const size_t row = (size_t)r * P.lanes;
      if (real && r < cread && f[row] < kBigHalf) {
        atomicOr(&cmask[(r >> 5) * 32 + l], 1u << (r & 31));
      } else {
        fo[row] = 0.f;
        fo[plane + row] = 0.f;
        fo[2 * plane + row] = 0.f;
      }
    }
  }
  __syncthreads();
  if (!real) return;
  const int cx = b * P.p + lane / P.s;
  const int cell = cx * P.s + lane % P.s;
  const int cy = lane % P.s / P.nz, cz = lane % P.nz;
  float4* run = rec + (size_t)cell * dense_capr(cap) * 2;
  for (int r = warp; r < cap; r += kCompactWarps) {
    const unsigned bit = 1u << (r & 31);
    const unsigned m = cmask[(r >> 5) * 32 + l];
    if (!(m & bit)) continue;
    int pos = __popc(m & (bit - 1u));
    for (int w = 0; w < (r >> 5); ++w) pos += __popc(cmask[w * 32 + l]);
    const size_t row = (size_t)r * P.lanes;
    const float q = kQ ? f[6 * plane + row] : 0.f;
    const int ty = kTypes ? (int)f[(kNf - 1) * plane + row] : 0;
    float x = f[row];
    if (P.per_x) x = in_cell_frame(x, cx, P.nx, P.lx, P.inv_lx, lo_x);
    const float y = in_cell_frame(f[plane + row], cy, P.ny, P.ly, P.inv_ly,
                                  lo_y);
    const float z = in_cell_frame(f[2 * plane + row], cz, P.nz, P.lz,
                                  P.inv_lz, lo_z);
    run[2 * pos] = make_float4(x, y, z, q);
    run[2 * pos + 1] = make_float4(
        __int_as_float(tag[(size_t)b * plane + row + lane]),
        __int_as_float(ty),
        __int_as_float(r), 0.f);
  }
  if (warp == 0) {
    int n = 0;
    for (int w = 0; w < words; ++w) n += __popc(cmask[w * 32 + l]);
    cnt[cell] = n;
  }
}

// Pass 2: one block per cell, one thread per live atom of the cell (in
// passes of kThreads atoms).  Thread 0 streams the stencil's record runs,
// in neighbor_offsets' order, through a ring of kRing slots (cp.async.bulk
// completing on one mbarrier a slot; a slot's phase flips each time it is
// filled), so every value the candidate loop reads is in shared memory.
// For each j cell a warp first tests the run 8 candidates at a time and
// keeps, per thread, a bit a candidate within the largest cutoff (the
// self pair cleared), then every thread takes the law on its own bits in
// ascending rank: the warp runs the law as many times as its busiest
// thread has pairs, not once for every candidate any thread has.  The
// image on a periodic axis is the j cell's shift, subtracted from the
// plain difference: with both records in their cells' frames it is the
// minimum image of every pair within the cutoff, and on atoms within
// their cells' frames it gives the tiled body's bytes.  Lanes, ranks and
// the law's arithmetic are the tiled body's.
template <int kLaw, int kExcl, bool kTypes>
__global__ void __launch_bounds__(kThreads, kDenseMinBlocks)
pair_dense(const int* __restrict__ pbond, const float4* __restrict__ rec,
           const int* __restrict__ cnt, float* __restrict__ out, Params P,
           const Tables T) {
  static_assert(kLaw != kDpd, "the dense records carry no velocity");
  constexpr bool kTyped = kTypes || kLaw == kLjrf;
  __shared__ float tab[kTyped ? kRows * kMaxPairs : 1];
  __shared__ __align__(8) uint64_t bar[kRing];
  __shared__ int jcell[27], jcnt[27];
  __shared__ float jsh[27][3];
  extern __shared__ float4 dsm[];
  const int tid = threadIdx.x;
  const int capr = dense_capr(P.cap);
  float4* ring = dsm;                                  // [kRing][capr][2]
  unsigned* msk = reinterpret_cast<unsigned*>(dsm + (size_t)kRing * capr * 2);
  float* zi_all = reinterpret_cast<float*>(
      msk + (size_t)dense_words(P.cap) * kThreads);   // [capr]
  int* by_z = reinterpret_cast<int*>(zi_all + capr);  // [capr]
  if constexpr (kTyped) {
    for (int k = tid; k < kRows * kMaxPairs; k += kThreads) tab[k] = T.v[k];
  }
  const int c = blockIdx.x;
  const int cz = c % P.nz, cy = c / P.nz % P.ny, cx = c / (P.nz * P.ny);
  // the stencil, less the slabs an open x axis lacks
  const int lo_x = !P.per_x && cx == 0;
  const int ns = 27 - 9 * (lo_x + (!P.per_x && cx == P.nx - 1));
  if (tid < ns) {
    const int k = tid + 9 * lo_x;
    int j[3] = {cx + k / 9 - 1, cy + k / 3 % 3 - 1, cz + k % 3 - 1};
    const int n[3] = {P.nx, P.ny, P.nz};
    const float len[3] = {P.lx, P.ly, P.lz};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      jsh[tid][a] = j[a] < 0 ? -len[a] : (j[a] >= n[a] ? len[a] : 0.f);
      j[a] = j[a] < 0 ? j[a] + n[a] : (j[a] >= n[a] ? j[a] - n[a] : j[a]);
    }
    jcell[tid] = (j[0] * P.ny + j[1]) * P.nz + j[2];
    jcnt[tid] = cnt[jcell[tid]];
  }
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
  }
  const int n_i = cnt[c];
  for (int a = tid; a < n_i; a += kThreads) {
    zi_all[a] = rec[((size_t)c * capr + a) * 2].z;
  }
  __syncthreads();
  // the cell's atoms in ascending z (ties by rank), so that a warp's atoms
  // lie in a slab of the cell: the stencil cells then find pairs for most
  // of its threads or for few, and the law's divergent loop runs fewer
  // times.  An atom's sum does not depend on which thread takes it.
  for (int a = tid; a < n_i; a += kThreads) {
    const float z = zi_all[a];
    int p = 0;
    for (int u = 0; u < n_i; ++u) {
      p += zi_all[u] < z || (zi_all[u] == z && u < a);
    }
    by_z[p] = a;
  }
  __syncthreads();
  const int total = (n_i + kThreads - 1) / kThreads * ns;
  // stream position g: stencil cell g % ns into slot g % kRing
  auto load_run = [&](int g) {
    const int k = g % ns;
    const unsigned bytes = (unsigned)jcnt[k] * 32u;
    uint64_t* b = &bar[g % kRing];
    mbar_expect_tx(b, bytes);
    if (bytes) {
      bulk_load(ring + (size_t)(g % kRing) * capr * 2,
                rec + (size_t)jcell[k] * capr * 2, bytes, b);
    }
  };
  if (tid == 0) {
    for (int g = 0; g < min(kRing, total); ++g) load_run(g);
  }
  const float cut2 = kTyped ? T.cut2_max : P.cut * P.cut;
  const int bi = cx / P.p;
  const int lane = (cx % P.p) * P.s + cy * P.nz + cz;
  const size_t plane = (size_t)P.cap * P.lanes;
  for (int a0 = 0, g = 0; a0 < n_i; a0 += kThreads) {
    const bool has_i = a0 + tid < n_i;
    const bool warp_on = a0 + (tid & ~31) < n_i;
    const int a = has_i ? by_z[a0 + tid] : 0;      // its place in the run
    float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f;
    int ri = 0, tbase = 0;
    int pt[4] = {-2, -2, -2, -2};
    if (has_i) {
      const float4 p = rec[((size_t)c * capr + a) * 2];
      const float4 e = rec[((size_t)c * capr + a) * 2 + 1];
      xi = p.x;
      yi = p.y;
      zi = p.z;
      qi = p.w;
      ri = __float_as_int(e.z);
      if constexpr (kTypes) tbase = __float_as_int(e.y) * T.ntypes;
      if constexpr (kExcl > 0) {
        const int* pb = pbond + (size_t)bi * kExcl * plane
                        + (size_t)ri * P.lanes + lane;
#pragma unroll
        for (int k = 0; k < kExcl; ++k) pt[k] = pb[k * plane];
      }
    }
    float fx = 0.f, fy = 0.f, fz = 0.f;
    for (int k = 0; k < ns; ++k, ++g) {
      mbar_wait(&bar[g % kRing], (g / kRing) & 1);
      const float4* slot = ring + (size_t)(g % kRing) * capr * 2;
      const int nj = jcnt[k];
      const float sx = jsh[k][0], sy = jsh[k][1], sz = jsh[k][2];
      if (warp_on) {
        // the candidates within the largest cutoff, a bit each (a j cell
        // without an image shift skips the shift's subtractions, which
        // would subtract 0)
        auto test = [&](auto shifted) {
          unsigned word = 0u;
          for (int q0 = 0; q0 < nj; q0 += 8) {
            unsigned v = 0u;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const float4 bj = slot[2 * (q0 + u)];
              float dx = xi - bj.x;
              float dy = yi - bj.y;
              float dz = zi - bj.z;
              if constexpr (decltype(shifted)::value) {
                dx = dx - sx;
                dy = dy - sy;
                dz = dz - sz;
              }
              const float rsq = dx * dx + dy * dy + dz * dz;
              if (rsq < cut2) v |= 1u << u;
            }
            if (q0 + 8 > nj) v &= (1u << (nj - q0)) - 1u;
            word |= v << (q0 & 31);
            if ((q0 & 31) == 24 || q0 + 8 >= nj) {
              msk[(q0 >> 5) * kThreads + tid] = has_i ? word : 0u;
              word = 0u;
            }
          }
        };
        if (sx == 0.f && sy == 0.f && sz == 0.f) {
          test(std::false_type{});
        } else {
          test(std::true_type{});
        }
        if (jcell[k] == c && has_i) {
          msk[(a >> 5) * kThreads + tid] &= ~(1u << (a & 31));
        }
        // the law on each thread's pairs, in ascending rank
        const int nw = (nj + 31) >> 5;
        int w = 0;
        unsigned m = nw > 0 ? msk[tid] : 0u;
        while (true) {
          while (m == 0u && ++w < nw) m = msk[w * kThreads + tid];
          if (m == 0u) break;
          const int q = (w << 5) + __ffs(m) - 1;
          m &= m - 1u;
          const float4 bj = slot[2 * q];
          const float4 ej = slot[2 * q + 1];
          const float dx = xi - bj.x - sx;
          const float dy = yi - bj.y - sy;
          const float dz = zi - bj.z - sz;
          const float rsq = dx * dx + dy * dy + dz * dz;
          const int tjx = __float_as_int(ej.x);
          if constexpr (kExcl == 2) {
            if (tjx == pt[0] || tjx == pt[1]) continue;
          } else if constexpr (kExcl == 4) {
            if (tjx == pt[0] || tjx == pt[1] || tjx == pt[2]
                || tjx == pt[3])
              continue;
          }
          if (!(rsq > kEps2)) continue;
          int tp = 0;                      // the type pair's table column
          if constexpr (kTypes) tp = tbase + __float_as_int(ej.y);
          float fpair;
          if constexpr (kLaw == kLj && !kTyped) {
            const float r2inv = 1.f / rsq;
            const float r6inv = r2inv * r2inv * r2inv;
            fpair = r6inv * (P.lj1 * r6inv - P.lj2) * r2inv;
          } else {
            fpair = 0.f;
            if (rsq < tab[kCut2 * kMaxPairs + tp]) {
              const float r2inv = 1.f / rsq;
              const float r6inv = r2inv * r2inv * r2inv;
              fpair = r6inv * (tab[kLj1 * kMaxPairs + tp] * r6inv
                               - tab[kLj2 * kMaxPairs + tp]) * r2inv;
            }
            if constexpr (kLaw == kLjrf) {
              if (rsq < T.cut_coul2) {
                const float rinv = rsqrtf(rsq);
                const float r2i = rinv * rinv;
                const float qprod = T.qq * qi * bj.w;
                fpair += qprod * (r2i * rinv
                                  - T.inv_rc3 * tab[kCrf * kMaxPairs + tp]);
              }
            }
          }
          fx += fpair * dx;
          fy += fpair * dy;
          fz += fpair * dz;
        }
      }
      __syncthreads();                 // the slot is read: refill it
      if (tid == 0 && g + kRing < total) load_run(g + kRing);
    }
    if (has_i) {
      float* fo = out + (size_t)bi * 3 * plane + (size_t)ri * P.lanes + lane;
      fo[0] = fx;
      fo[plane] = fy;
      fo[2 * plane] = fz;
    }
  }
}

}  // namespace

// The source's parts.  Compiled whole (OBMD_PAIR_PART undefined), the file
// holds every instantiation.  _build.py compiles it as SOURCE_PARTS
// translation units at once (OBMD_PAIR_PART = 0 .. 11) and links them
// into one library, so that nvcc's front end and ptxas, which take one
// core each per translation unit, run on every core: part 0 holds the
// entry points and make_dpd_kernel's instantiations, and calls start_part
// for make_pair_kernel's tiled body and start_dense for its dense body;
// parts 1-6 instantiate start_part for the dpd law, one (exclusion
// channels, types) each, 7-8 for lj and 9-10 for ljrf, one type flag
// each, part 11 start_dense.
namespace obmd_pair_detail {

#define OBMD_START_ARGS                                                      \
  const dim3 &grid, cudaStream_t st, const void *fld, const void *tag,      \
      const void *occ, const void *pbond, void *out, bool gauss, bool ramp, \
      const Launch &P, const Tables &T

template <int kLaw, bool kLegacy, int kExcl, bool kTypes>
int start_part(OBMD_START_ARGS)
#if defined(OBMD_PAIR_PART) && OBMD_PAIR_PART == 0
    ;
#else
{
  return start_noise<kLaw, kLegacy, kExcl, kTypes>(
      grid, st, fld, tag, occ, pbond, out, gauss, ramp, P, T);
}
#endif

#if defined(OBMD_PAIR_PART) && OBMD_PAIR_PART > 0 && OBMD_PAIR_PART <= 10
#define OBMD_PART(law, excl, types) \
  template int start_part<law, false, excl, types>(OBMD_START_ARGS);
#if OBMD_PAIR_PART <= 6
OBMD_PART(kDpd, 2 * ((OBMD_PAIR_PART - 1) / 2), (OBMD_PAIR_PART - 1) % 2 == 1)
#else
#define OBMD_LAW (OBMD_PAIR_PART <= 8 ? kLj : kLjrf)
#define OBMD_TYPES (OBMD_PAIR_PART % 2 == 0)
OBMD_PART(OBMD_LAW, 0, OBMD_TYPES)
OBMD_PART(OBMD_LAW, 2, OBMD_TYPES)
OBMD_PART(OBMD_LAW, 4, OBMD_TYPES)
#endif
#elif defined(OBMD_PAIR_PART) && OBMD_PAIR_PART > 11
#error "pair_kernel.cu has parts 0-11"
#endif

#define OBMD_DENSE_ARGS                                                  \
  cudaStream_t st, const void *fld, const void *tag, const void *occ,    \
      const void *pbond, void *out, const Launch &P, const Tables &T

// The dense body's two passes.  scratch: the records,
// [cells][dense_capr(cap)][8] words, then the cells' counts.
template <int kLaw, int kExcl, bool kTypes>
int start_dense(OBMD_DENSE_ARGS)
#if defined(OBMD_PAIR_PART) && OBMD_PAIR_PART != 11
    ;
#else
{
  constexpr int kNf = 6 + (kLaw == kLjrf) + kTypes;
  const int ncells = P.nx * P.ny * P.nz;
  float4* rec = static_cast<float4*>(P.scratch);
  int* cnt = reinterpret_cast<int*>(
      rec + (size_t)ncells * dense_capr(P.cap) * 2);
  auto* body = pair_dense<kLaw, kExcl, kTypes>;
  static int allowed = 48 * 1024;
  if (const int e = allow_smem(body, P, allowed)) return e;
  const dim3 cgrid((unsigned)((P.lanes + 31) / 32), (unsigned)P.nb);
  dense_compact<kNf, kLaw == kLjrf, kTypes>
      <<<cgrid, kCompactWarps * 32, (P.cap + 31) / 32 * 32 * 4, st>>>(
          (const float*)fld, (const int*)tag, (const int*)occ, (float*)out,
          rec, cnt, P, P.lo_x, P.lo_y, P.lo_z);
  body<<<ncells, kThreads, P.smem, st>>>((const int*)pbond, rec, cnt,
                                          (float*)out, P, T);
  return 0;
}
#endif

// part 11: the dense rows' law, path I's and K's water
#if defined(OBMD_PAIR_PART) && OBMD_PAIR_PART == 11
template int start_dense<kLjrf, 2, true>(OBMD_DENSE_ARGS);
#endif

}  // namespace obmd_pair_detail

#if !defined(OBMD_PAIR_PART) || OBMD_PAIR_PART == 11
// The dense body's blocks an SM at `smem` bytes of dynamic shared memory
// (TilePlan.smem_bytes), into *resident: cudaOccupancyMaxActiveBlocks-
// PerMultiprocessor of its one instantiation.
extern "C" int obmd_pair_dense_resident(int smem, int* resident) {
  if (resident == nullptr || smem < 0 || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  auto* body = pair_dense<kLjrf, 2, true>;
  cudaError_t e = cudaFuncSetAttribute(
      body, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident, body, kThreads, smem);
}
#endif

#if !defined(OBMD_PAIR_PART) || OBMD_PAIR_PART == 0
namespace {

// The type flag at run time -> the instantiation (make_dpd_kernel has one
// type): make_dpd_kernel's here, make_pair_kernel's through start_part.
template <int kLaw, bool kLegacy, int kExcl>
int start_types(const dim3& grid, cudaStream_t st, const void* fld,
                const void* tag, const void* occ, const void* pbond,
                void* out, bool types, bool gauss, bool ramp,
                const Launch& P, const Tables& T) {
  if constexpr (kLegacy) {
    if (types) return (int)cudaErrorInvalidValue;
    return start_noise<kLaw, kLegacy, kExcl, false>(
        grid, st, fld, tag, occ, pbond, out, gauss, ramp, P, T);
  } else if (!types) {
    return obmd_pair_detail::start_part<kLaw, kLegacy, kExcl, false>(
        grid, st, fld, tag, occ, pbond, out, gauss, ramp, P, T);
  } else {
    return obmd_pair_detail::start_part<kLaw, kLegacy, kExcl, true>(
        grid, st, fld, tag, occ, pbond, out, gauss, ramp, P, T);
  }
}

// The exclusion channels at run time -> the instantiation: none, two (chains)
// or four (branched topologies; make_pair_kernel's only, as make_dpd_kernel
// has two).
template <int kLaw, bool kLegacy>
int start_law(const dim3& grid, cudaStream_t st, const void* fld,
              const void* tag, const void* occ, const void* pbond, void* out,
              int n_excl, bool types, bool gauss, bool ramp, const Launch& P,
              const Tables& T) {
  if (n_excl == 0) {
    return start_types<kLaw, kLegacy, 0>(grid, st, fld, tag, occ, pbond, out,
                                         types, gauss, ramp, P, T);
  } else if (n_excl == 2) {
    return start_types<kLaw, kLegacy, 2>(grid, st, fld, tag, occ, pbond, out,
                                         types, gauss, ramp, P, T);
  } else if constexpr (kLegacy) {
    return (int)cudaErrorInvalidValue;
  } else {
    return start_types<kLaw, kLegacy, 4>(grid, st, fld, tag, occ, pbond, out,
                                         types, gauss, ramp, P, T);
  }
}

template <bool kLegacy>
int launch(const void* fld, const void* tag, const void* occ,
           const void* pbond, void* out, int law, int n_excl,
           const float* tables, int ntypes, int gaussian, int ramp,
           const Launch& P, void* stream) {
  if (P.lanes <= 0 || P.cap <= 0 || P.nb <= 0 || P.p * P.s > P.lanes)
    return (int)cudaErrorInvalidValue;
  // the tile plan: tiles within the grid (one cell and one block a tile
  // for the dense body), and the caller's shared memory figure
  // (TilePlan.smem_bytes) equal to the layout the body carves
  if (P.tile_x < 1 || P.tile_x > P.nx || P.tile_y < 1 || P.tile_y > P.ny
      || P.tile_z < 1 || P.tile_z > P.nz || P.split < 1
      || (P.dense && (P.tile_x * P.tile_y * P.tile_z != 1 || P.split != 1
                      || P.scratch == nullptr))
      || (long long)P.smem != (P.dense ? dense_smem(P.cap) : smem_bytes(P))
      || P.smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  if (!(n_excl == 0 || ((n_excl == 2 || n_excl == 4) && pbond != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (ntypes < 1 || ntypes * ntypes > kMaxPairs)
    return (int)cudaErrorInvalidValue;
  const bool types = ntypes > 1;
  Tables T{};
  if (types || law == kLjrf) {
    // tables: cut2_max, qq, cut_coul2, inv_rc3, then the kRows rows of
    // ntypes^2 values each, laid out here at stride kMaxPairs
    if (tables == nullptr) return (int)cudaErrorInvalidValue;
    T.ntypes = ntypes;
    T.cut2_max = tables[0];
    T.qq = tables[1];
    T.cut_coul2 = tables[2];
    T.inv_rc3 = tables[3];
    const int n = ntypes * ntypes;
    for (int k = 0; k < kRows; ++k)
      for (int i = 0; i < n; ++i) T.v[k * kMaxPairs + i] = tables[4 + k * n + i];
  }
  const bool gauss = gaussian != 0, rmp = ramp != 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (P.dense) {
    // built for the dense rows' law only (pair_kernel.check_dense): ljrf
    // with types and two exclusion channels, y and z periodic with >= 3
    // cells each
    if (kLegacy || law != kLjrf || !types || n_excl != 2 || gauss || rmp
        || !P.per_y || !P.per_z || P.ny < 3 || P.nz < 3
        || (P.per_x && P.nx < 3))
      return (int)cudaErrorInvalidValue;
    const int rc = obmd_pair_detail::start_dense<kLjrf, 2, true>(
        st, fld, tag, occ, pbond, out, P, T);
    if (rc != 0) return rc;
    return (int)cudaGetLastError();
  }
  const int tiles = ((P.nx + P.tile_x - 1) / P.tile_x)
                    * ((P.ny + P.tile_y - 1) / P.tile_y)
                    * ((P.nz + P.tile_z - 1) / P.tile_z);
  const dim3 grid((unsigned)tiles, (unsigned)P.split);
  int rc;
  if (law == kDpd) {
    rc = start_law<kDpd, kLegacy>(grid, st, fld, tag, occ, pbond, out,
                                  n_excl, types, gauss, rmp, P, T);
  } else if (law == kLj) {
    rc = start_law<kLj, kLegacy>(grid, st, fld, tag, occ, pbond, out,
                                 n_excl, types, gauss, rmp, P, T);
  } else if (law == kLjrf) {
    if constexpr (kLegacy) {
      return (int)cudaErrorInvalidValue;  // make_dpd_kernel has no charges
    } else {
      rc = start_law<kLjrf, kLegacy>(grid, st, fld, tag, occ, pbond, out,
                                     n_excl, types, gauss, rmp, P, T);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

#define OBMD_PAIR_ARGS                                                       \
  const void *fld, const void *tag, const void *occ, const void *pbond,     \
      void *out, int nb, int cap, int lanes, int nx, int ny, int nz, int s, \
      int p, int per_x, int per_y, int per_z, int law, int n_excl,         \
      float lx, float ly, float lz,                                         \
      float inv_lx, float inv_ly, float inv_lz, float a0, float gamma,      \
      float sigma, float cut, float inv_cut, float dtinvsqrt, float lj1,    \
      float lj2, uint32_t salt, const float *tables, int ntypes,            \
      int gaussian, int ramp, float sig_scale, int tile_x, int tile_y,     \
      int tile_z, int split, int smem, int dense, void *scratch,           \
      float lo_x, float lo_y, float lo_z, void *stream
#define OBMD_PAIR_PARAMS                                                     \
  Launch{{nb, cap, lanes, nx, ny, nz, s, p, per_x, lx, ly, lz, inv_lx,      \
          inv_ly, inv_lz, a0, gamma, sigma, cut, inv_cut, dtinvsqrt, lj1,   \
          lj2, salt, sig_scale, per_y, per_z, tile_x, tile_y, tile_z, split,\
          smem},                                                             \
         dense, scratch, lo_x, lo_y, lo_z}

// make_pair_kernel's function (TPU kernels #1 and #2).
extern "C" int obmd_pair(OBMD_PAIR_ARGS) {
  return launch<false>(fld, tag, occ, pbond, out, law, n_excl, tables,
                       ntypes, gaussian, ramp, OBMD_PAIR_PARAMS, stream);
}

// make_dpd_kernel's function (TPU kernel #3).
extern "C" int obmd_dpd_full(OBMD_PAIR_ARGS) {
  return launch<true>(fld, tag, occ, pbond, out, law, n_excl, tables,
                      ntypes, gaussian, ramp, OBMD_PAIR_PARAMS, stream);
}
#endif  // the entry points: the whole source, or part 0
