// The USHER steered-insertion search for both buffers in one launch, for
// Hopper (sm_90a), with the DPD law (entry point obmd_usher_search) or the
// lj/cut law (obmd_usher_search_lj).  The lj entry point also runs the
// lj/cut/rf law's rows: an ATOM-mode trial atom is neutral, so the reaction
// field adds nothing, and the rows are the lj ones per type pair with
// eshift = 0 (pallas_usher.py:57-75).
//
// Replaces: obmd_tpu/forces/pallas_usher.py make_usher_kernel (:79-254,
// kernel body :110-229), called through usher_search_pallas (:257-311);
// the laws' per-atom rows are usher_law's (:42-76), their energy and force
// the kernel's energy_force (:135-171).
//
// Inputs: rows f32[2][R][B] (per side: x, y, z of each subset atom, then
// the law's coefficient rows against the trial type; R = 5 for DPD with
// a0, cut; R = 7 for lj/cut with lj3, lj4, cut, eshift; padding rows at
// x = BIG with cut = 1 and every other coefficient 0), cand f32[2][K][3],
// bounds f32[2][6] (region lo xyz, hi xyz).  Outputs: pos f32[2][K][3],
// accepted i32[2][K], iters i32[2][K].
//
// Function (ref fix_obmd_merged.cpp:1518-1616, with the arithmetic of
// obmd_tpu/obmd/subset.py usher_search_subset_batch, the plain version):
// each iteration evaluates the trial energy E and force F of the candidate
// against all B subset atoms; E < etarget + eps accepts; otherwise the
// candidate steps along F/|F| by ds_ovlp = dsovlp - (4 eps / E)^(1/12) when
// E > uovlp, else by ds = min((E - etarget)/|F|, ds0); leaving the
// insertion region or a degenerate force rejects.  After nattempt
// iterations a last energy check accepts candidates still active and below
// target.  The laws, each counted for 1e-10 < r < rc only:
//   dpd: E = sum 0.5*a0*rc*wd^2, F = sum a0*wd*rhat, wd = 1 - r/rc, with
//        r = sqrt(r^2) (the TPU kernel: r^2 * rsqrt(r^2));
//   lj:  E = sum r6inv*(lj3*r6inv - lj4) - eshift,
//        F = sum r6inv*(12*lj3*r6inv - 6*lj4)*r2inv * d, r2inv = 1/r^2,
//        r6inv = r2inv^3.  Where this follows the plain version rather
//        than the TPU kernel: the r ~ 0 test is r^2 > 1e-20 and the
//        reciprocal 1/max(r^2, 1e-10), as forces/pairs.make_pair_law (the
//        TPU kernel: r^2 > 1e-12 and 1/max(r^2, 1e-12); no real pair is
//        that close, so both exclude the same pairs); the plain law takes
//        48*eps*sig^12 and 24*eps*sig^6 as its force coefficients, which
//        equal 12*lj3 and 6*lj4 up to one float32 rounding of each (exactly
//        at eps = sig = 1), and computes the shift in float32 where the rows
//        carry it rounded from float64.  LJ's r^-12 core takes E far above
//        uovlp = 1e4 (DPD's soft energy never does), so the overlap step
//        runs here; its (4 eps / E)^(1/12) is powf in float32, accurate to
//        an ulp over the 1e4-1e12 range such candidates start in.
//
// Design.  A candidate's iterations are sequential, so its whole search
// stays inside one thread block: the grid is (K candidates, 2 sides).  Each
// iteration is a block-wide reduction of (E, Fx, Fy, Fz) over the subset
// (each thread strides over B), then thread 0 applies the step rule and
// publishes the new position through shared memory.  A candidate that has
// stopped leaves its loop at once; the TPU kernel runs all iterations
// masked, with the same result.  The law is a template parameter of the
// energy evaluation, so each entry point compiles its own loop.
//
// Bound on an H100: operations.  The subset rows are 2 x R x B floats
// (~0.9 MB at R = 7, B = 16k), read from L2 on every iteration, while each
// energy evaluation costs a ~15-flop distance test per subset atom and the
// law's ~20 more only on the few dozen atoms within the cutoff.
// With only 2 x K = 32 blocks the card is far from full, and every
// iteration pays a block barrier and a reduction: latency, not throughput,
// bounds this first version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Params {
  int B, K, nattempt;
  float ly, lz;
  float thresh, etarget, ds0, uovlp, dsovlp, four_eps, eps;
};

enum Law { kDpd = 0, kLj = 1 };

template <int kLaw>
struct LawRows;
template <>
struct LawRows<kDpd> {
  static constexpr int kRows = 5;   // x, y, z, a0, cut
};
template <>
struct LawRows<kLj> {
  static constexpr int kRows = 7;   // x, y, z, lj3, lj4, cut, eshift
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide (E, Fx, Fy, Fz) of the trial position p; the result is valid in
// thread 0 only.
template <int kLaw>
__device__ void energy_force(const float* __restrict__ R, int B, const float p[3],
                             float ly, float lz, float out[4],
                             float (*red)[kWarps]) {
  float e = 0.f, fx = 0.f, fy = 0.f, fz = 0.f;
  for (int j = threadIdx.x; j < B; j += kThreads) {
    const float dx = p[0] - R[j];
    float dy = p[1] - R[B + j];
    float dz = p[2] - R[2 * B + j];
    if (ly > 0.f) dy = dy - ly * rintf(dy / ly);
    if (lz > 0.f) dz = dz - lz * rintf(dz / lz);
    const float rsq = dx * dx + dy * dy + dz * dz;
    if (kLaw == kDpd) {
      const float a0 = R[3 * B + j];
      const float cut = R[4 * B + j];
      const float r = sqrtf(rsq);
      const bool inr = (rsq < cut * cut) && (r > 1e-10f);
      if (inr) {
        const float rinv = 1.f / fmaxf(r, 1e-10f);
        const float wd = 1.f - r / cut;
        e += 0.5f * a0 * cut * wd * wd;
        const float fp = a0 * wd * rinv;
        fx += fp * dx;
        fy += fp * dy;
        fz += fp * dz;
      }
    } else {
      const float lj3 = R[3 * B + j];
      const float lj4 = R[4 * B + j];
      const float cut = R[5 * B + j];
      const float esh = R[6 * B + j];
      const bool inr = (rsq < cut * cut) && (rsq > 1e-20f);
      if (inr) {
        const float r2inv = 1.f / fmaxf(rsq, 1e-10f);
        const float r6inv = r2inv * r2inv * r2inv;
        e += r6inv * (lj3 * r6inv - lj4) - esh;
        const float fp = r6inv * (12.f * lj3 * r6inv - 6.f * lj4) * r2inv;
        fx += fp * dx;
        fy += fp * dy;
        fz += fp * dz;
      }
    }
  }
  e = warp_sum(e);
  fx = warp_sum(fx);
  fy = warp_sum(fy);
  fz = warp_sum(fz);
  const int w = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    red[0][w] = e;
    red[1][w] = fx;
    red[2][w] = fy;
    red[3][w] = fz;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int c = 0; c < 4; ++c) {
      float s = 0.f;
      for (int i = 0; i < kWarps; ++i) s += red[c][i];
      out[c] = s;
    }
  }
  __syncthreads();
}

template <int kLaw>
__global__ void __launch_bounds__(kThreads)
usher_kernel(const float* __restrict__ rows, const float* __restrict__ cand,
             const float* __restrict__ bounds, float* __restrict__ out_pos,
             int* __restrict__ out_acc, int* __restrict__ out_iters, Params P) {
  const int k = blockIdx.x;
  const int side = blockIdx.y;
  const float* R = rows + (size_t)side * LawRows<kLaw>::kRows * P.B;
  __shared__ float red[4][kWarps];
  __shared__ float pos[3];
  __shared__ int active, accepted, iters;
  float ef[4];
  const float* bnd = bounds + side * 6;
  if (threadIdx.x == 0) {
    for (int c = 0; c < 3; ++c) pos[c] = cand[((size_t)side * P.K + k) * 3 + c];
    active = 1;
    accepted = 0;
    iters = 0;
  }
  __syncthreads();
  for (int it = 0; it < P.nattempt; ++it) {
    if (!active) break;                 // block-uniform: read after a barrier
    float p[3] = {pos[0], pos[1], pos[2]};
    energy_force<kLaw>(R, P.B, p, P.ly, P.lz, ef, red);
    if (threadIdx.x == 0) {
      const float E = ef[0];
      const bool ok = E < P.thresh;
      const float fabs_ = sqrtf(ef[1] * ef[1] + ef[2] * ef[2] + ef[3] * ef[3]);
      const bool degen = fabs_ < P.eps;
      const float ds_ovlp = P.dsovlp - powf(P.four_eps / fmaxf(E, P.eps),
                                            1.0f / 12.0f);
      const float ds_norm = fminf((E - P.etarget) / fmaxf(fabs_, P.eps), P.ds0);
      const float ds = E > P.uovlp ? ds_ovlp : ds_norm;
      const float fn = fmaxf(fabs_, P.eps);
      float m[3];
      bool inside = true;
      for (int c = 0; c < 3; ++c) {
        m[c] = p[c] + (ef[c + 1] / fn) * ds;
        inside = inside && (m[c] >= bnd[c]) && (m[c] <= bnd[3 + c]);
      }
      const bool move_now = !ok && !degen;
      if (move_now)
        for (int c = 0; c < 3; ++c) pos[c] = m[c];
      const bool stopped = ok || degen || (move_now && !inside);
      if (ok) accepted = 1;
      if (stopped) active = 0;
      else iters += 1;
    }
    __syncthreads();
  }
  if (active) {                         // post-loop acceptance check
    float p[3] = {pos[0], pos[1], pos[2]};
    energy_force<kLaw>(R, P.B, p, P.ly, P.lz, ef, red);
    if (threadIdx.x == 0 && ef[0] < P.thresh) accepted = 1;
  }
  if (threadIdx.x == 0) {
    const size_t o = (size_t)side * P.K + k;
    for (int c = 0; c < 3; ++c) out_pos[o * 3 + c] = pos[c];
    out_acc[o] = accepted;
    out_iters[o] = iters;
  }
}

template <int kLaw>
int launch(const void* rows, const void* cand, const void* bounds,
           void* out_pos, void* out_acc, void* out_iters, const Params& P,
           void* stream) {
  if (P.B <= 0 || P.K <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid(P.K, 2);
  usher_kernel<kLaw><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)cand, (const float*)bounds,
      (float*)out_pos, (int*)out_acc, (int*)out_iters, P);
  return (int)cudaGetLastError();
}

}  // namespace

#define OBMD_USHER_ARGS                                                      \
  const void *rows, const void *cand, const void *bounds, void *out_pos,    \
      void *out_acc, void *out_iters, int B, int K, int nattempt, float ly, \
      float lz, float thresh, float etarget, float ds0, float uovlp,        \
      float dsovlp, float four_eps, float eps, void *stream
#define OBMD_USHER_PARAMS                                                    \
  Params{B, K, nattempt, ly, lz, thresh, etarget, ds0, uovlp, dsovlp,       \
         four_eps, eps}

// The DPD law: rows f32[2][5][B].
extern "C" int obmd_usher_search(OBMD_USHER_ARGS) {
  return launch<kDpd>(rows, cand, bounds, out_pos, out_acc, out_iters,
                      OBMD_USHER_PARAMS, stream);
}

// The lj/cut law: rows f32[2][7][B].
extern "C" int obmd_usher_search_lj(OBMD_USHER_ARGS) {
  return launch<kLj>(rows, cand, bounds, out_pos, out_acc, out_iters,
                     OBMD_USHER_PARAMS, stream);
}
