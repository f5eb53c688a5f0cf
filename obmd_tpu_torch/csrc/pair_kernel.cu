// DPD pair forces over the padded cell-major layout, for Hopper (sm_90a).
//
// Replaces: obmd_tpu/forces/pallas_dpd.py make_pair_kernel, both of its
// bodies — kernel_bigtile (:575-797, fill cap <= 20) and the rank-looped
// kernel (:324-559, fill cap > 20).  They compute one function, and this
// one kernel takes any capacity.
//
// Layout (the TPU kernel's calling convention): fld f32[nb][6][cap][lanes]
// with channels x, y, z, vx, vy, vz (dead slots at x = BIG), tag
// i32[nb][cap][lanes], occ i32[nb] (highest occupied rank + 1 per block),
// out f32[nb][3][cap][lanes].  Slot (b, r, l) holds rank r of the cell at
// lane l of block b; lane l covers x-slab b*p + l/s and the (y, z) cell
// l % s.
//
// Design.  Newton-off: one thread per slot sums F_ij over every atom filed
// in the 27 cells around its own FILED cell, so there are no atomics and no
// cross-block reaction pass (the TPU kernel's out2 shift).  The x axis is
// open (neighbour slabs outside [0, nx) are skipped), y/z are periodic with
// >= 3 cells, so the 27 cells are distinct and the minimum image is applied
// per pair.  A CUDA block is one (block, rank) row of 128 lanes: neighbouring
// threads read neighbouring cells, so each (offset, j-rank) step of the
// j-loop is a near-coalesced row read.  The j-rank loop stops at occ of the
// neighbour's block.  The pair noise is the reference's counter hash of
// (salt, smaller tag, larger tag), bit for bit.
//
// Bound on an H100: the two bounds are close.  At the bench size (scale 9,
// ~107k atoms, 223k slots at cap 15) the function reads ~6.3 MB of fields
// and tags and writes ~2.7 MB, ~2.7 us at 3.35 TB/s; it needs ~11M
// candidate-pair distance tests and ~0.7M force evaluations, each pair
// once, ~2.9 us at the f32 peak (chip_smoke.py counts both from its run's
// inputs: operations bound at cap 15, bytes at cap 24).  This first version
// does each pair twice (Newton-off) and keeps the j rows in L1/L2 (no
// shared-memory staging); chip_smoke.py reports its time against the bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBigHalf = 0.5e8f;
constexpr float kEps2 = 1.0e-20f;
constexpr float kSqrt3 = 1.7320508075688772f;

struct Params {
  int nb, cap, lanes, nx, ny, nz, s, p;
  float ly, lz, inv_ly, inv_lz;
  float a0, gamma, sigma, cut, inv_cut, dtinvsqrt;
  uint32_t salt;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(128)
dpd_pair_kernel(const float* __restrict__ fld, const int* __restrict__ tag,
                const int* __restrict__ occ, float* __restrict__ out,
                Params P) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x / P.cap;
  const int r = blockIdx.x % P.cap;
  const size_t plane = (size_t)P.cap * P.lanes;
  const size_t row = (size_t)r * P.lanes + lane;
  const float* fi = fld + (size_t)b * 6 * plane + row;
  const float xi = fi[0], yi = fi[plane], zi = fi[2 * plane];
  const float vxi = fi[3 * plane], vyi = fi[4 * plane], vzi = fi[5 * plane];
  const int cx = b * P.p + lane / P.s;
  const bool live = (lane < P.p * P.s) && (cx < P.nx) && (xi < kBigHalf);
  float fx = 0.f, fy = 0.f, fz = 0.f;
  if (live) {
    const int ti = tag[(size_t)b * plane + row];
    const int within = lane % P.s;
    const int cy = within / P.nz, cz = within % P.nz;
    const float cut2 = P.cut * P.cut;
    for (int ox = -1; ox <= 1; ++ox) {
      const int jx = cx + ox;
      if (jx < 0 || jx >= P.nx) continue;
      const int bj = jx / P.p;
      const int lbase = (jx % P.p) * P.s;
      const int ocj = min(occ[bj], P.cap);
      const float* fj = fld + (size_t)bj * 6 * plane;
      const int* tj = tag + (size_t)bj * plane;
      for (int oy = -1; oy <= 1; ++oy) {
        const int jy = (cy + oy + P.ny) % P.ny;
        for (int oz = -1; oz <= 1; ++oz) {
          const int lj = lbase + jy * P.nz + (cz + oz + P.nz) % P.nz;
          for (int rj = 0; rj < ocj; ++rj) {
            if (bj == b && lj == lane && rj == r) continue;
            const size_t o = (size_t)rj * P.lanes + lj;
            const float dx = xi - fj[o];
            float dy = yi - fj[plane + o];
            float dz = zi - fj[2 * plane + o];
            dy = dy - P.ly * rintf(dy * P.inv_ly);
            dz = dz - P.lz * rintf(dz * P.inv_lz);
            const float rsq = dx * dx + dy * dy + dz * dz;
            if (!(rsq < cut2 && rsq > kEps2)) continue;
            const float rinv = rsqrtf(rsq);
            const float wd = 1.f - (rsq * rinv) * P.inv_cut;
            const float dot = dx * (vxi - fj[3 * plane + o])
                            + dy * (vyi - fj[4 * plane + o])
                            + dz * (vzi - fj[5 * plane + o]);
            const int tjv = tj[o];
            const uint32_t lo = (uint32_t)min(ti, tjv);
            const uint32_t hi = (uint32_t)max(ti, tjv);
            const uint32_t h = fmix32((lo * 0x9E3779B9u) ^ (hi * 0x85EBCA77u)
                                      ^ P.salt);
            const float u01 = (float)(h >> 8) * (1.0f / 16777216.0f);
            const float noise = kSqrt3 * (2.f * u01 - 1.f);
            float fpair = P.a0 * wd;
            fpair = fpair - P.gamma * wd * wd * dot * rinv;
            fpair = fpair + P.sigma * wd * noise * P.dtinvsqrt;
            fpair = fpair * rinv;
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

}  // namespace

extern "C" int obmd_dpd_pair(const void* fld, const void* tag, const void* occ,
                             void* out, int nb, int cap, int lanes, int nx,
                             int ny, int nz, int s, int p, float ly, float lz,
                             float inv_ly, float inv_lz, float a0, float gamma,
                             float sigma, float cut, float inv_cut,
                             float dtinvsqrt, uint32_t salt, void* stream) {
  if (lanes != 128) return (int)cudaErrorInvalidValue;
  Params P{nb, cap, lanes, nx, ny, nz, s, p, ly, lz, inv_ly, inv_lz,
           a0, gamma, sigma, cut, inv_cut, dtinvsqrt, salt};
  dpd_pair_kernel<<<nb * cap, lanes, 0, (cudaStream_t)stream>>>(
      (const float*)fld, (const int*)tag, (const int*)occ, (float*)out, P);
  return (int)cudaGetLastError();
}
