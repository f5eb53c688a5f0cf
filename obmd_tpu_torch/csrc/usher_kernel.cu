// The USHER steered-insertion search for both buffers in one C call, for
// Hopper (sm_90a), with the DPD law (entry point obmd_usher_search) or the
// lj/cut law (obmd_usher_search_lj).  The lj entry point also runs the
// lj/cut/rf law's rows: an ATOM-mode trial atom is neutral, so the reaction
// field adds nothing, and the rows are the lj ones per type pair with
// eshift = 0 (pallas_usher.py:57-75).  Every entry point has a float64
// twin (obmd_usher_search_f64, obmd_usher_search_lj_f64) for a float64
// scene's subsets: the same code on double rows, parameters, sums and
// steps, the counterpart of the XLA usher_search_subset that the JAX
// nlist engine runs at x64 (obmd_tpu/obmd/stage.py:397-421).
//
// Replaces: obmd_tpu/forces/pallas_usher.py make_usher_kernel (:79-254,
// kernel body :110-229), called through usher_search_pallas (:257-311);
// the laws' coefficients are usher_law's (:42-76), their energy and force
// the kernel's energy_force (:135-171).
//
// Inputs, per side (left, right): the buffer subset as the engine builds
// it, x real[B][3], type i32[B], valid u8[B] (B may differ between the
// sides), and the candidates real[K][3], real float32 or (the _f64 entry
// points) float64; on the host, in the same real type: each side's cell
// grid (cells per axis, origin, inverse cell side), the two insertion
// regions, and the law's coefficients against the trial type by
// subset-atom type (dpd: a0, cut; lj: lj3, lj4, cut, eshift; at most 4
// types).  Scratch i32, laid out per side as scratch_words() says.
// Outputs: pos real[2][K][3], accepted bool[2][K], iters i32[2][K].
//
// Function (ref fix_obmd_merged.cpp:1518-1616, with the arithmetic of
// obmd_tpu/obmd/subset.py usher_search_subset_batch, the plain version):
// each iteration evaluates the trial energy E and force F of the candidate
// against the valid subset atoms; E < etarget + eps accepts; otherwise the
// candidate steps along F/|F| by ds_ovlp = dsovlp - (4 eps / E)^(1/12) when
// E > uovlp, else by ds = min((E - etarget)/|F|, ds0); leaving the
// insertion region or a degenerate force rejects.  After nattempt
// iterations a last energy check accepts candidates still active and below
// target.  The laws, each counted for 1e-10 < r < rc only:
//   dpd: E = sum 0.5*a0*rc*wd^2, F = sum a0*wd*rhat, wd = 1 - r/rc;
//   lj:  E = sum r6inv*(lj3*r6inv - lj4) - eshift,
//        F = sum r6inv*(12*lj3*r6inv - 6*lj4)*r2inv * d, r2inv = 1/r^2,
//        r6inv = r2inv^3, with the plain version's r ~ 0 test
//        (r^2 > 1e-20) and reciprocal 1/max(r^2, 1e-10).
// The minimum image on periodic y and z is the plain version's
// d - L*rint(d/L); x is open (OBMD's buffers).
//
// Design.  Four kernels and a memset on the caller's stream, enqueued by
// one C call.
//  1. Binning, three grid-wide passes after a memset of the counts:
//     bin_count files each valid row in its cell of the side's grid and
//     counts the cells (global atomics), and the side's last row block
//     scans the counts into each cell's start; bin_scatter scatters the
//     row indices into their cells' segments; bin_write writes each row's
//     (x, y, z, type) as one Row4 (16 bytes, or 32 in float64) at its
//     cell's start plus its rank among the cell's rows by ascending row
//     index, so the sorted rows are the same bytes on every launch.  Cells are numbered with x fastest:
//     x is open, so a stencil's x neighbours are one contiguous run.
//  2. usher_kernel, one block of Warps<law> warps per candidate (grid K x
//     2, spread over the SMs; 4 warps for DPD's ~85 stencil atoms, 8 for
//     LJ's ~400, the fastest of 1-16 timed by usher_probe.py): each energy
//     evaluation finds the candidate's cell and the 9 (y, z) runs of up to
//     3 x cells around it (a periodic axis of fewer than 3 cells visits
//     each cell once), and the threads stride over the runs' atoms; a
//     butterfly shuffle sums each warp, the warps' sums meet in shared
//     memory behind one barrier, and every thread adds them in warp order,
//     so all hold the same E and F and apply the step rule alike.
// A cell side is at least the law's largest cut against the trial type
// (forces/usher_kernel.UsherGrid), so the stencil holds every atom within
// the cutoff.  The sums run in another order than the plain version's,
// so a verdict within an ulp of the gate may differ; the smoke compares
// margin-robust candidates.  A row is filed in the real type the search
// reads it in (axis_cell<T>), so a row on a cell face lands in a cell the
// stencil of a trial beside it visits.
//
// Bound on an H100: latency.  The work per call is a few million float32
// operations (float64 in the twins, at half the rate: 34 TFLOP/s), a few
// microseconds at the card's rate; but a candidate's up to 41
// evaluations are a dependent chain, each a cell-table load, a
// pass or two over the stencil's atoms (~85 for DPD at rho 3, ~400 for LJ
// at rho* 0.84) from L1/L2, the reductions and the step rule.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBinThreads = 1024;
constexpr int kMaxTypes = 4;
constexpr int kCoef = 4;
// the scan's copy of one side's counts in bin_count's dynamic shared
// memory, which shares the default 48 KB with the block's static arrays
// (warp_tot and last: kBinStatic bytes at most)
constexpr int kSmemDefault = 48 * 1024;
constexpr int kBinStatic = 1024;
constexpr int kMaxCells = (kSmemDefault - kBinStatic) / 4;
static_assert(sizeof(int) * (kBinThreads / 32) + 16 <= kBinStatic,
              "bin_count's static shared memory outgrows kBinStatic");
constexpr unsigned kFull = 0xffffffffu;

enum Law { kDpd = 0, kLj = 1 };

// One sorted subset row: x, y, z and the type as a real.  16-byte aligned,
// so a float row is one 16-byte load and a double row two.
template <typename T>
struct alignas(16) Row4 {
  T x, y, z, w;
};

__device__ __forceinline__ Row4<float> load_row(const Row4<float>* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  return {a.x, a.y, a.z, a.w};
}

__device__ __forceinline__ Row4<double> load_row(const Row4<double>* p) {
  const double2* q = reinterpret_cast<const double2*>(p);
  const double2 a = __ldg(q), b = __ldg(q + 1);
  return {a.x, a.y, b.x, b.y};
}

// The math of each real type, named once so the float code is the float
// library's (floorf, sqrtf, ...) and the double code the double library's.
__device__ __forceinline__ float r_floor(float v) { return floorf(v); }
__device__ __forceinline__ double r_floor(double v) { return floor(v); }
__device__ __forceinline__ float r_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double r_min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float r_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double r_max(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float r_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double r_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float r_rint(float v) { return rintf(v); }
__device__ __forceinline__ double r_rint(double v) { return rint(v); }
__device__ __forceinline__ float r_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double r_pow(double a, double b) {
  return pow(a, b);
}
__device__ __forceinline__ void r_nan(float* v) {
  *v = __int_as_float(0x7fc00000);
}
__device__ __forceinline__ void r_nan(double* v) {
  *v = __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
struct Side {
  const T* x;
  const int* type;
  const unsigned char* valid;
  const T* cand;
  int b;
  int n[3];          // cells per axis
  T o[3];            // grid origin
  T inv_h[3];        // reciprocal of the cell side, in T
  T lo[3], hi[3];    // the insertion region
  int* cnt;          // [ncell + 1] rows per cell, then fill cursors; the
                     // last word counts finished row blocks
  int* start;        // [ncell + 1] first sorted row of each cell
  int* cellof;       // [b] each row's cell (-1: invalid)
  int* tmp;          // [b] row indices scattered by cell
  Row4<T>* rows;     // [b] sorted rows: x, y, z, type
};

template <typename T>
struct Params {
  Side<T> s[2];
  int K, nattempt, ntypes;
  T ly, lz;
  T thresh, etarget, ds0, uovlp, dsovlp, four_eps, eps;
  T coef[kMaxTypes * kCoef];
  T* out_pos;
  unsigned char* out_acc;  // bool
  int* out_iters;
};

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

// The cell of v on one axis: floor((v - o) * inv_h), wrapped on a periodic
// axis, clamped to the grid on an open one (forces/usher_kernel.py
// UsherGrid.cell3 is the same rule), in the real type T of the rows.
template <typename T>
__device__ __forceinline__ int axis_cell(T v, T o, T inv_h, int n,
                                         bool wrap) {
  T f = r_floor((v - o) * inv_h);
  f = r_min(r_max(f, T(-1.0e6)), T(1.0e6));
  int c = (int)f;
  if (wrap) {
    c %= n;
    if (c < 0) c += n;
  } else {
    c = min(max(c, 0), n - 1);
  }
  return c;
}

// Stencil neighbour c + off on a y or z axis; false where the axis has no
// such cell (open edge, or a periodic axis of fewer than 3 cells, which
// visits each of its cells once through the offsets 0 .. n - 1).
__device__ __forceinline__ bool stencil_cell(int c, int off, int n, bool wrap,
                                             int* out) {
  if (wrap) {
    if (n < 3 && (off < 0 || off >= n)) return false;
    *out = (c + off + n) % n;
    return true;
  }
  *out = c + off;
  return *out >= 0 && *out < n;
}

template <typename T>
__device__ __forceinline__ Side<T> pick(const Params<T>& P, int side) {
  return side ? P.s[1] : P.s[0];
}

template <typename T>
__device__ __forceinline__ int row_cell(const Side<T>& S, int i, bool wy,
                                        bool wz) {
  const int cx = axis_cell(S.x[3 * i], S.o[0], S.inv_h[0], S.n[0], false);
  const int cy = axis_cell(S.x[3 * i + 1], S.o[1], S.inv_h[1], S.n[1], wy);
  const int cz = axis_cell(S.x[3 * i + 2], S.o[2], S.inv_h[2], S.n[2], wz);
  return (cz * S.n[1] + cy) * S.n[0] + cx;
}

// Pass 1, one thread per subset row (grid: row blocks x 2 sides): file
// each valid row in its cell (cellof, -1 for an invalid row) and count the
// cells' rows; the side's last block to finish scans the counts into each
// cell's start and turns the counts into fill cursors.
template <typename T>
__global__ void __launch_bounds__(kBinThreads) bin_count(Params<T> P) {
  extern __shared__ int sh[];
  __shared__ int warp_tot[kBinThreads / 32];
  __shared__ bool last;
  const Side<T> S = pick(P, blockIdx.y);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int ncell = S.n[0] * S.n[1] * S.n[2];
  const int i = blockIdx.x * kBinThreads + tid;
  if (i < S.b) {
    int c = -1;
    if (S.valid[i]) {
      c = row_cell(S, i, P.ly > T(0), P.lz > T(0));
      atomicAdd(&S.cnt[c], 1);
    }
    S.cellof[i] = c;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&S.cnt[ncell], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // exclusive scan: thread t owns a contiguous range of cells
#pragma unroll 4
  for (int c = tid; c < ncell; c += kBinThreads) sh[c] = __ldcg(S.cnt + c);
  __syncthreads();
  const int per = (ncell + kBinThreads - 1) / kBinThreads;
  const int c0 = min(tid * per, ncell), c1 = min(c0 + per, ncell);
  int sum = 0;
  for (int c = c0; c < c1; ++c) sum += sh[c];
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_tot[w] = incl;
  __syncthreads();
  if (w == 0) {
    int v = warp_tot[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += u;
    }
    warp_tot[lane] = v;
  }
  __syncthreads();
  int run = incl - sum + (w > 0 ? warp_tot[w - 1] : 0);
  for (int c = c0; c < c1; ++c) {
    S.start[c] = run;
    S.cnt[c] = run;                     // now each cell's fill cursor
    run += sh[c];
  }
  if (tid == 0) S.start[ncell] = warp_tot[kBinThreads / 32 - 1];
}

// Pass 2, one thread per subset row: scatter each valid row's index into
// its cell's segment (in no fixed order within the cell).
template <typename T>
__global__ void __launch_bounds__(kBinThreads) bin_scatter(Params<T> P) {
  const Side<T> S = pick(P, blockIdx.y);
  const int i = blockIdx.x * kBinThreads + threadIdx.x;
  if (i >= S.b) return;
  const int c = S.cellof[i];
  if (c >= 0) S.tmp[atomicAdd(&S.cnt[c], 1)] = i;
}

// Pass 3, one thread per sorted slot: each scattered row goes to its
// cell's start plus its rank by row index among the cell's rows, as a
// Row4 of x, y, z and its type clamped to the table, so the sorted rows
// are the same bytes on every launch.
template <typename T>
__global__ void __launch_bounds__(kBinThreads) bin_write(Params<T> P) {
  const Side<T> S = pick(P, blockIdx.y);
  const int p = blockIdx.x * kBinThreads + threadIdx.x;
  const int ncell = S.n[0] * S.n[1] * S.n[2];
  if (p >= S.start[ncell]) return;
  const int i = S.tmp[p];
  const int c = S.cellof[i];
  const int s = S.start[c], e = S.start[c + 1];
  int rank = 0;
  for (int q = s; q < e; ++q) rank += S.tmp[q] < i;
  const int t = min(max(S.type[i], 0), P.ntypes - 1);
  S.rows[s + rank] = Row4<T>{S.x[3 * i], S.x[3 * i + 1], S.x[3 * i + 2],
                             (T)t};
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Warps per candidate: the block that searches one candidate.
template <int kLaw>
struct Warps;
template <>
struct Warps<kDpd> {
  static constexpr int value = 4;
};
template <>
struct Warps<kLj> {
  static constexpr int value = 8;
};

// (E, Fx, Fy, Fz) of the trial position p against the atoms of its
// stencil, the same in every thread of the block: each warp strides over
// the stencil's atoms (thread t of the block takes atoms t, t + 32 kW,
// ...), sums its lanes with a butterfly, and with several warps the
// warps' sums meet in red[parity] (two buffers, so one barrier an
// evaluation suffices) and every thread adds them in warp order.
template <typename T, int kLaw, int kW>
__device__ __forceinline__ void energy_force(const Side<T>& S,
                                             const Params<T>& P,
                                             const T* coef, const T p[3],
                                             T out[4], T (*red)[kW][4],
                                             int parity) {
  const int lane = threadIdx.x & 31;
  const bool wy = P.ly > T(0), wz = P.lz > T(0);
  const int cx = axis_cell(p[0], S.o[0], S.inv_h[0], S.n[0], false);
  const int cy = axis_cell(p[1], S.o[1], S.inv_h[1], S.n[1], wy);
  const int cz = axis_cell(p[2], S.o[2], S.inv_h[2], S.n[2], wz);
  const int xlo = max(cx - 1, 0), xhi = min(cx + 1, S.n[0] - 1);
  // lane r < 9 holds run r: the x cells xlo..xhi of (y, z) neighbour r
  int len = 0, first = 0;
  if (lane < 9) {
    int yy, zz;
    if (stencil_cell(cy, lane / 3 - 1, S.n[1], wy, &yy) &&
        stencil_cell(cz, lane % 3 - 1, S.n[2], wz, &zz)) {
      const int base = (zz * S.n[1] + yy) * S.n[0];
      first = __ldg(S.start + base + xlo);
      len = __ldg(S.start + base + xhi + 1) - first;
    }
  }
  int incl = len;
  for (int o = 1; o < 16; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  const int off = first - (incl - len);   // sorted row = flat index + off
  int run_end[9], run_off[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    run_end[r] = __shfl_sync(kFull, incl, r);
    run_off[r] = __shfl_sync(kFull, off, r);
  }
  const int total = run_end[8];
  T e = T(0), fx = T(0), fy = T(0), fz = T(0);
  for (int t = threadIdx.x; t < total; t += 32 * kW) {
    int o = run_off[8];
#pragma unroll
    for (int r = 7; r >= 0; --r)
      if (t < run_end[r]) o = run_off[r];
    const Row4<T> a = load_row(S.rows + t + o);
    const T* cf = coef + kCoef * (int)a.w;
    const T dx = p[0] - a.x;
    T dy = p[1] - a.y;
    T dz = p[2] - a.z;
    if (wy) dy = dy - P.ly * r_rint(dy / P.ly);
    if (wz) dz = dz - P.lz * r_rint(dz / P.lz);
    const T rsq = dx * dx + dy * dy + dz * dz;
    if (kLaw == kDpd) {
      const T a0 = cf[0], cut = cf[1];
      const T r = r_sqrt(rsq);
      if ((rsq < cut * cut) && (r > T(1e-10))) {
        const T rinv = T(1) / r_max(r, T(1e-10));
        const T wd = T(1) - r / cut;
        e += T(0.5) * a0 * cut * wd * wd;
        const T fp = a0 * wd * rinv;
        fx += fp * dx;
        fy += fp * dy;
        fz += fp * dz;
      }
    } else {
      const T lj3 = cf[0], lj4 = cf[1], cut = cf[2], esh = cf[3];
      if ((rsq < cut * cut) && (rsq > T(1e-20))) {
        const T r2inv = T(1) / r_max(rsq, T(1e-10));
        const T r6inv = r2inv * r2inv * r2inv;
        e += r6inv * (lj3 * r6inv - lj4) - esh;
        const T fp = r6inv * (T(12) * lj3 * r6inv - T(6) * lj4) * r2inv;
        fx += fp * dx;
        fy += fp * dy;
        fz += fp * dz;
      }
    }
  }
  out[0] = warp_sum(e);
  out[1] = warp_sum(fx);
  out[2] = warp_sum(fy);
  out[3] = warp_sum(fz);
  if (kW > 1) {
    const int w = threadIdx.x >> 5;
    if (lane == 0)
      for (int c = 0; c < 4; ++c) red[parity][w][c] = out[c];
    __syncthreads();
    for (int c = 0; c < 4; ++c) {
      T v = red[parity][0][c];
      for (int u = 1; u < kW; ++u) v += red[parity][u][c];
      out[c] = v;
    }
  }
}

template <typename T, int kLaw>
__global__ void __launch_bounds__(32 * Warps<kLaw>::value)
usher_kernel(Params<T> P) {
  constexpr int kW = Warps<kLaw>::value;
  __shared__ T coef[kMaxTypes * kCoef];
  __shared__ T red[2][kW][4];
  const int k = blockIdx.x, side = blockIdx.y;
  const Side<T> S = pick(P, side);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxTypes * kCoef; ++i) coef[i] = P.coef[i];
  }
  __syncthreads();
  T p[3];
  for (int c = 0; c < 3; ++c) p[c] = S.cand[k * 3 + c];
  // A candidate with a non-finite coordinate meets no atom within the
  // cut, but the plain version's force sums 0 x inf over every subset row
  // (obmd/subset.py _batched_energy_force pads both sides to one length),
  // which is NaN: its force is NaN here too, so it stops where the plain
  // search stops.
  const bool nan_force =
      !(isfinite(p[0]) && isfinite(p[1]) && isfinite(p[2])) &&
      (P.s[0].b > 0 || P.s[1].b > 0);
  // every thread holds the same sums, so the block takes every branch
  // alike
  bool active = true, accepted = false;
  int iters = 0;
  T ef[4];
  for (int it = 0; it < P.nattempt && active; ++it) {
    energy_force<T, kLaw, kW>(S, P, coef, p, ef, red, it & 1);
    if (nan_force)
      for (int c = 1; c < 4; ++c) r_nan(&ef[c]);
    const T E = ef[0];
    const bool ok = E < P.thresh;
    const T fabs_ = r_sqrt(ef[1] * ef[1] + ef[2] * ef[2] + ef[3] * ef[3]);
    const bool degen = fabs_ < P.eps;
    const T fn = r_max(fabs_, P.eps);
    T ds;
    if (E > P.uovlp)   // the overlap step
      ds = P.dsovlp - r_pow(P.four_eps / r_max(E, P.eps), T(1) / T(12));
    else
      ds = r_min((E - P.etarget) / fn, P.ds0);
    T m[3];
    bool inside = true;
    for (int c = 0; c < 3; ++c) {
      m[c] = p[c] + (ef[c + 1] / fn) * ds;
      inside = inside && (m[c] >= S.lo[c]) && (m[c] <= S.hi[c]);
    }
    const bool move_now = !ok && !degen;
    if (move_now)
      for (int c = 0; c < 3; ++c) p[c] = m[c];
    const bool stopped = ok || degen || (move_now && !inside);
    if (ok) accepted = true;
    if (stopped) active = false;
    else iters += 1;
  }
  if (active) {                         // post-loop acceptance check
    energy_force<T, kLaw, kW>(S, P, coef, p, ef, red, P.nattempt & 1);
    if (ef[0] < P.thresh) accepted = true;
  }
  if (threadIdx.x == 0) {
    const int o = side * P.K + k;
    for (int c = 0; c < 3; ++c) P.out_pos[o * 3 + c] = p[c];
    P.out_acc[o] = accepted;
    P.out_iters[o] = iters;
  }
}

// Words of scratch one side takes (forces/usher_kernel.py scratch_words):
// its counts (zeroed by the launch; both sides' come first), its starts,
// the rows' cells, the scattered indices and the sorted Row4 rows (4 or 8
// words a row).
long long count_words(int ncell) { return align4(ncell + 1); }
template <typename T>
long long side_words(int ncell, int b) {
  return count_words(ncell) + align4(ncell + 1) + 2LL * align4(b) +
         (long long)(sizeof(Row4<T>) / sizeof(int)) * b;
}

template <typename T, int kLaw>
int launch(const void* const* sub, const int* b, const void* const* cand,
           int K, void* scratch, long long scratch_words, void* out_pos,
           void* out_acc, void* out_iters, const int* cells, const T* grid,
           const T* bounds, const T* coef, int ntypes, int nattempt, T ly,
           T lz, T thresh, T etarget, T ds0, T uovlp, T dsovlp, T four_eps,
           T eps, void* stream) {
  if (K <= 0 || ntypes < 1 || ntypes > kMaxTypes || nattempt < 0)
    return (int)cudaErrorInvalidValue;
  Params<T> P{};
  int ncell[2];
  for (int s = 0; s < 2; ++s) {
    const int* n = cells + 3 * s;
    if (b[s] < 0 || n[0] < 1 || n[1] < 1 || n[2] < 1 ||
        (long long)n[0] * n[1] * n[2] > kMaxCells)
      return (int)cudaErrorInvalidValue;
    ncell[s] = n[0] * n[1] * n[2];
  }
  // both sides' counts first (one memset zeroes them), then each side's
  // starts, cells, scattered indices and sorted rows
  const long long zero_words = count_words(ncell[0]) + count_words(ncell[1]);
  long long words = zero_words;
  for (int s = 0; s < 2; ++s) {
    Side<T>& S = P.s[s];
    S.x = (const T*)sub[3 * s];
    S.type = (const int*)sub[3 * s + 1];
    S.valid = (const unsigned char*)sub[3 * s + 2];
    S.cand = (const T*)cand[s];
    S.b = b[s];
    S.cnt = (int*)scratch + (s ? count_words(ncell[0]) : 0);
    S.start = (int*)scratch + words;
    S.cellof = S.start + align4(ncell[s] + 1);
    S.tmp = S.cellof + align4(b[s]);
    S.rows = (Row4<T>*)(S.tmp + align4(b[s]));
    for (int c = 0; c < 3; ++c) {
      S.n[c] = cells[3 * s + c];
      S.o[c] = grid[6 * s + c];
      S.inv_h[c] = grid[6 * s + 3 + c];
      S.lo[c] = bounds[6 * s + c];
      S.hi[c] = bounds[6 * s + 3 + c];
    }
    words += side_words<T>(ncell[s], b[s]) - count_words(ncell[s]);
  }
  if (words != scratch_words || ((uintptr_t)scratch & 15) != 0)
    return (int)cudaErrorInvalidValue;
  P.K = K;
  P.nattempt = nattempt;
  P.ntypes = ntypes;
  P.ly = ly;
  P.lz = lz;
  P.thresh = thresh;
  P.etarget = etarget;
  P.ds0 = ds0;
  P.uovlp = uovlp;
  P.dsovlp = dsovlp;
  P.four_eps = four_eps;
  P.eps = eps;
  for (int i = 0; i < kMaxTypes * kCoef; ++i) P.coef[i] = coef[i];
  P.out_pos = (T*)out_pos;
  P.out_acc = (unsigned char*)out_acc;
  P.out_iters = (int*)out_iters;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(scratch, 0, zero_words * sizeof(int), st);
  if (rc != cudaSuccess) return (int)rc;
  const int rows = b[0] > b[1] ? b[0] : b[1];
  const int row_blocks = rows > 0 ? (rows + kBinThreads - 1) / kBinThreads : 1;
  const dim3 row_grid(row_blocks, 2);
  const int ncell_max = ncell[0] > ncell[1] ? ncell[0] : ncell[1];
  bin_count<T><<<row_grid, kBinThreads, ncell_max * sizeof(int), st>>>(P);
  bin_scatter<T><<<row_grid, kBinThreads, 0, st>>>(P);
  bin_write<T><<<row_grid, kBinThreads, 0, st>>>(P);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  constexpr int threads = 32 * Warps<kLaw>::value;
  usher_kernel<T, kLaw><<<dim3(K, 2), threads, 0, st>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// The source's parts.  Compiled whole (OBMD_USHER_PART undefined), the
// file holds every entry point.  _build.py compiles it as two translation
// units at once (SOURCE_PARTS: OBMD_USHER_PART = 0, the float32 entry
// points; 1, the float64 ones) and links them into one library, so the
// float64 instantiations add no time to the build.
#define OBMD_USHER_ARGS(real)                                                \
  const void *x_l, const void *type_l, const void *valid_l, int b_l,        \
      const void *x_r, const void *type_r, const void *valid_r, int b_r,    \
      const void *cand_l, const void *cand_r, int K, void *scratch,         \
      long long scratch_words, void *out_pos, void *out_acc,                \
      void *out_iters, const int *cells, const real *grid,                  \
      const real *bounds, const real *coef, int ntypes, int nattempt,       \
      real ly, real lz, real thresh, real etarget, real ds0, real uovlp,    \
      real dsovlp, real four_eps, real eps, void *stream
#define OBMD_USHER_CALL(real, law)                                           \
  const void* sub[6] = {x_l, type_l, valid_l, x_r, type_r, valid_r};        \
  const int b[2] = {b_l, b_r};                                              \
  const void* cand[2] = {cand_l, cand_r};                                   \
  return launch<real, law>(sub, b, cand, K, scratch, scratch_words,         \
                           out_pos, out_acc, out_iters, cells, grid,        \
                           bounds, coef, ntypes, nattempt, ly, lz, thresh,  \
                           etarget, ds0, uovlp, dsovlp, four_eps, eps,      \
                           stream)

#if !defined(OBMD_USHER_PART) || OBMD_USHER_PART == 0
// The DPD law: coef rows (a0, cut, 0, 0) by subset-atom type.
extern "C" int obmd_usher_search(OBMD_USHER_ARGS(float)) {
  OBMD_USHER_CALL(float, kDpd);
}

// The lj/cut law: coef rows (lj3, lj4, cut, eshift) by subset-atom type.
extern "C" int obmd_usher_search_lj(OBMD_USHER_ARGS(float)) {
  OBMD_USHER_CALL(float, kLj);
}
#endif

#if !defined(OBMD_USHER_PART) || OBMD_USHER_PART == 1
// The same laws on float64 subsets, candidates, parameters and outputs.
extern "C" int obmd_usher_search_f64(OBMD_USHER_ARGS(double)) {
  OBMD_USHER_CALL(double, kDpd);
}

extern "C" int obmd_usher_search_lj_f64(OBMD_USHER_ARGS(double)) {
  OBMD_USHER_CALL(double, kLj);
}
#endif

#if defined(OBMD_USHER_PART) && (OBMD_USHER_PART < 0 || OBMD_USHER_PART > 1)
#error "usher_kernel.cu has parts 0-1"
#endif
