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
// Design.  Newton-off: one thread per slot sums F_ij over every live atom
// filed in the stencil's cells around its own FILED cell (27 where every
// axis has >= 3 cells), so there are no atomics and no cross-block
// reaction pass (the Newton kernel's out2 shift).  x is
// open (neighbour slabs outside [0, nx) are skipped) or periodic with >= 3
// cells (the slab index wraps); y and z are periodic with >= 3 cells (the
// cell index wraps), or, in the instantiations with the geometry flags,
// periodic with a single cell or open:
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
// pair on every periodic axis.  A dead j slot is skipped by testing its x
// against BIG/2, not by distance: the minimum image on x folds BIG back
// into the box, and the fused multiply-add nvcc makes of it leaves a
// residue inside the cutoff.  A CUDA block is 128 lanes of one (block,
// rank) row (lanes / 128 blocks per row): neighbouring threads read
// neighbouring cells, so each (offset, j-rank) step of the j-loop is a
// near-coalesced row read.  The j-rank loop stops at occ of the
// neighbour's block.  The pair noise is the reference's counter hash of
// (salt, smaller tag, larger tag), bit for bit.
// Exclusion: each thread loads its slot's kExcl partner tags (2 or 4, a
// template parameter, so the loads and compares unroll and the tags stay
// in registers) once and skips an in-cutoff j whose tag equals one.
// Newton-off visits every pair
// from both ends and each end checks only its own partners; that equals
// the TPU kernels' one-sided check because partner lists are symmetric
// (state.init_state builds both directions of every bond).  -2 matches no
// tag (live tags are >= 1, dead slots carry -1 and are skipped first).
// Four channels are instantiated for make_pair_kernel's typed dpd law with
// uniform noise on periodic y and z (a branched melt's), only.
// The channel count, the law and the type tables are template parameters,
// so a 6-channel one-type launch runs the same machine code as before they
// existed.  So are the DPD law's two variants, instantiated for obmd_pair's
// dpd law only (make_dpd_kernel has neither):
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
// inputs.  This first version
// does each pair twice (Newton-off) and keeps the j rows in L1/L2 (no
// shared-memory staging); chip_smoke.py reports its time against the bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBigHalf = 0.5e8f;
constexpr float kEps = 1.0e-10f;
constexpr float kEps2 = 1.0e-20f;
constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kTwoPi = 6.2831855f;      // float32(2 pi), as the TPU kernel
constexpr int kThreads = 128;

enum Law { kDpd = 0, kLj = 1, kLjrf = 2 };

struct Params {
  int nb, cap, lanes, nx, ny, nz, s, p, per_x;
  float lx, ly, lz, inv_lx, inv_ly, inv_lz;
  float a0, gamma, sigma, cut, inv_cut, dtinvsqrt, lj1, lj2;
  uint32_t salt;
  float sig_scale;                 // read by the ramp instantiations only
  int per_y, per_z;                // read by the kOpen instantiations only
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

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
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
  if constexpr (kTyped) {
    for (int k = threadIdx.x; k < kRows * kMaxPairs; k += kThreads)
      tab[k] = T.v[k];
    __syncthreads();
  }
  const int lane = blockIdx.y * kThreads + threadIdx.x;
  const int b = blockIdx.x / P.cap;
  const int r = blockIdx.x % P.cap;
  const size_t plane = (size_t)P.cap * P.lanes;
  const size_t row = (size_t)r * P.lanes + lane;
  const float* fi = fld + (size_t)b * kNf * plane + row;
  const float xi = fi[0], yi = fi[plane], zi = fi[2 * plane];
  const int cx = b * P.p + lane / P.s;
  const bool live = (lane < P.p * P.s) && (cx < P.nx) && (xi < kBigHalf);
  float fx = 0.f, fy = 0.f, fz = 0.f;
  if (live) {
    float vxi = 0.f, vyi = 0.f, vzi = 0.f;
    int ti = 0;
    if (kLaw == kDpd) {
      vxi = fi[3 * plane];
      vyi = fi[4 * plane];
      vzi = fi[5 * plane];
      ti = tag[(size_t)b * plane + row];
    }
    float qi = 0.f;
    if constexpr (kLaw == kLjrf) qi = fi[kChQ * plane];
    int tbase = 0;                       // ti * T: the row of i's type
    if constexpr (kTypes) tbase = (int)fi[kChT * plane] * T.ntypes;
    int pt[4] = {-2, -2, -2, -2};          // the partner tags
    if constexpr (kExcl > 0) {
      const int* pb = pbond + (size_t)b * kExcl * plane + row;
#pragma unroll
      for (int c = 0; c < kExcl; ++c) pt[c] = pb[c * plane];
    }
    const int within = lane % P.s;
    const int cy = within / P.nz, cz = within % P.nz;
    const float cut2 = kTyped ? T.cut2_max : P.cut * P.cut;
    for (int ox = -1; ox <= 1; ++ox) {
      int jx = cx + ox;
      if (P.per_x) {
        jx = (jx + P.nx) % P.nx;
      } else if (jx < 0 || jx >= P.nx) {
        continue;
      }
      const int bj = jx / P.p;
      const int lbase = (jx % P.p) * P.s;
      const int ocj = min(occ[bj], P.cap);
      const float* fj = fld + (size_t)bj * kNf * plane;
      const int* tj = tag + (size_t)bj * plane;
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
          int lj;
          if constexpr (kOpen) {
            int jz = cz + oz;
            if (P.per_z) {
              jz = (jz + P.nz) % P.nz;
            } else if (jz < 0 || jz >= P.nz) {
              continue;
            }
            lj = lbase + jy * P.nz + jz;
          } else {
            lj = lbase + jy * P.nz + (cz + oz + P.nz) % P.nz;
          }
          for (int rj = 0; rj < ocj; ++rj) {
            if (bj == b && lj == lane && rj == r) continue;
            const size_t o = (size_t)rj * P.lanes + lj;
            // all three loads first, then one branch for dead or distant
            const float xj = fj[o];
            float dx = xi - xj;
            float dy = yi - fj[plane + o];
            float dz = zi - fj[2 * plane + o];
            if (P.per_x) dx = dx - P.lx * rintf(dx * P.inv_lx);
            if (!kOpen || P.per_y) dy = dy - P.ly * rintf(dy * P.inv_ly);
            if (!kOpen || P.per_z) dz = dz - P.lz * rintf(dz * P.inv_lz);
            const float rsq = dx * dx + dy * dy + dz * dz;
            if (!(rsq < cut2 && xj < kBigHalf)) continue;
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
  }
  float* fo = out + (size_t)b * 3 * plane + row;
  fo[0] = fx;
  fo[plane] = fy;
  fo[2 * plane] = fz;
}

template <int kLaw, bool kLegacy, int kExcl, bool kTypes, bool kGauss,
          bool kRamp, bool kOneCell, bool kOpen>
void start_geo(const dim3& grid, cudaStream_t st, const void* fld,
               const void* tag, const void* occ, const void* pbond,
               void* out, const Params& P, const Tables& T) {
  pair_kernel<kLaw, kLegacy, kExcl, kTypes, kGauss, kRamp, kOneCell, kOpen>
      <<<grid, kThreads, 0, st>>>((const float*)fld, (const int*)tag,
                                  (const int*)occ, (const int*)pbond,
                                  (float*)out, P, T);
}

// The geometry flags at run time -> the instantiation: a single-cell y or
// z axis, an open y or z axis (make_pair_kernel's only).
template <int kLaw, bool kLegacy, int kExcl, bool kTypes, bool kGauss,
          bool kRamp>
int start(const dim3& grid, cudaStream_t st, const void* fld,
          const void* tag, const void* occ, const void* pbond, void* out,
          const Params& P, const Tables& T) {
  const bool one_cell = P.ny == 1 || P.nz == 1;
  const bool open = !(P.per_y && P.per_z);
  if (!one_cell && !open) {
    start_geo<kLaw, kLegacy, kExcl, kTypes, kGauss, kRamp, false, false>(
        grid, st, fld, tag, occ, pbond, out, P, T);
  } else if (!open) {
    start_geo<kLaw, kLegacy, kExcl, kTypes, kGauss, kRamp, true, false>(
        grid, st, fld, tag, occ, pbond, out, P, T);
  } else if constexpr (kLegacy) {
    return (int)cudaErrorInvalidValue;    // make_dpd_kernel has no open y/z
  } else if (!one_cell) {
    start_geo<kLaw, kLegacy, kExcl, kTypes, kGauss, kRamp, false, true>(
        grid, st, fld, tag, occ, pbond, out, P, T);
  } else {
    start_geo<kLaw, kLegacy, kExcl, kTypes, kGauss, kRamp, true, true>(
        grid, st, fld, tag, occ, pbond, out, P, T);
  }
  return 0;
}

// The noise flags at run time -> the instantiation: gaussian noise and the
// ramp exist for make_pair_kernel's dpd law only.
template <int kLaw, bool kLegacy, int kExcl, bool kTypes>
int start_noise(const dim3& grid, cudaStream_t st, const void* fld,
                const void* tag, const void* occ, const void* pbond,
                void* out, bool gauss, bool ramp, const Params& P,
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

// The exclusion flag and the type flag at run time -> the instantiation.
template <int kLaw, bool kLegacy>
int start_law(const dim3& grid, cudaStream_t st, const void* fld,
              const void* tag, const void* occ, const void* pbond, void* out,
              bool excl, bool types, bool gauss, bool ramp, const Params& P,
              const Tables& T) {
  if (!types && !excl) {
    return start_noise<kLaw, kLegacy, 0, false>(
        grid, st, fld, tag, occ, pbond, out, gauss, ramp, P, T);
  } else if (!types) {
    return start_noise<kLaw, kLegacy, 2, false>(
        grid, st, fld, tag, occ, pbond, out, gauss, ramp, P, T);
  } else if constexpr (kLegacy) {
    return (int)cudaErrorInvalidValue;    // make_dpd_kernel has one type
  } else if (!excl) {
    return start_noise<kLaw, kLegacy, 0, true>(
        grid, st, fld, tag, occ, pbond, out, gauss, ramp, P, T);
  } else {
    return start_noise<kLaw, kLegacy, 2, true>(
        grid, st, fld, tag, occ, pbond, out, gauss, ramp, P, T);
  }
}

template <bool kLegacy>
int launch(const void* fld, const void* tag, const void* occ,
           const void* pbond, void* out, int law, int n_excl,
           const float* tables, int ntypes, int gaussian, int ramp,
           const Params& P, void* stream) {
  if (P.lanes <= 0 || P.lanes % kThreads != 0 || P.cap <= 0 || P.nb <= 0)
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
  const bool excl = n_excl == 2;
  const bool gauss = gaussian != 0, rmp = ramp != 0;
  const dim3 grid((unsigned)(P.nb * P.cap), (unsigned)(P.lanes / kThreads));
  const cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (n_excl == 4) {
    // four channels: make_pair_kernel's typed dpd law, uniform noise, y and
    // z periodic with >= 3 cells (a branched melt's), the one instantiation
    if constexpr (kLegacy) {
      return (int)cudaErrorInvalidValue;  // make_dpd_kernel has two
    } else {
      if (law != kDpd || !types || gauss || rmp || P.ny == 1 || P.nz == 1
          || !(P.per_y && P.per_z))
        return (int)cudaErrorInvalidValue;
      start_geo<kDpd, false, 4, true, false, false, false, false>(
          grid, st, fld, tag, occ, pbond, out, P, T);
      return (int)cudaGetLastError();
    }
  }
  if (law == kDpd) {
    rc = start_law<kDpd, kLegacy>(grid, st, fld, tag, occ, pbond, out, excl,
                                  types, gauss, rmp, P, T);
  } else if (law == kLj) {
    rc = start_law<kLj, kLegacy>(grid, st, fld, tag, occ, pbond, out, excl,
                                 types, gauss, rmp, P, T);
  } else if (law == kLjrf) {
    if constexpr (kLegacy) {
      return (int)cudaErrorInvalidValue;  // make_dpd_kernel has no charges
    } else {
      rc = start_law<kLjrf, kLegacy>(grid, st, fld, tag, occ, pbond, out,
                                     excl, types, gauss, rmp, P, T);
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
      int gaussian, int ramp, float sig_scale, void *stream
#define OBMD_PAIR_PARAMS                                                     \
  Params{nb, cap, lanes, nx, ny, nz, s, p, per_x, lx, ly, lz, inv_lx,       \
         inv_ly, inv_lz, a0, gamma, sigma, cut, inv_cut, dtinvsqrt, lj1,    \
         lj2, salt, sig_scale, per_y, per_z}

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
