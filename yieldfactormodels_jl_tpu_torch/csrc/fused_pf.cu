// Fused Rao-Blackwellised SV particle filter for Hopper (sm_90a) — K5.
//
// Replaces the Pallas TPU kernel yieldfactormodels_jl_tpu/ops/pallas_pf.py
// (_kernel, launched by pf_loglik_batch through pl.pallas_call): the whole
// (T−1)-step particle filter of each parameter draw under stochastic-
// volatility measurement errors, in its common-noise mode — log-vol proposal
// from streamed normals, N scalar Potter square-root updates per particle,
// the float blend of a predict-only NaN column, propagation with an unrolled
// Cholesky of Φ S (Φ S)ᵀ + Ω, the max-shifted logsumexp of the weights and
// ESS-gated systematic resampling from streamed offsets — in one launch.
// The arithmetic is the one written out in ops/particle.py (_filter), the
// plain version ops/fused_pf.pf_loglik_batch_reference runs, which is what
// this kernel is held against.
//
// What bounds it.  A particle-step needs about 4.5 kFLOP at AFNS5, N = 20
// (3Ms² + 3.5Ms multiply-adds and four transcendentals per observed update;
// Ms³ + the Cholesky per propagation), so config 3 (1,000 draws × 1,000
// particles × 359 steps) is ≈1.6 TFLOP against 1.5 GB of float32 normals:
// the card's operation rate bounds it, not memory.  This kernel does more
// than that: the downdate scales Sφφᵀ by α per entry (Ms² products more an
// update) and a step blends its update with the predict-only state even
// when every column is observed.
//
// The design.  One block runs one draw and thread j holds particle slot j
// (P ≤ 1024 threads, a multiple of 32; slots n_eff..P−1 are dead: weight
// −Inf, their state copied from the last live particle at a resampling).
// Above 1,024 slots a second kernel runs 1,024 threads a draw, each over
// slots j, j + 1024, …, their state in global scratch (below).  A
// particle's β (Ms), S (Ms², full after the Potter updates), h and log-weight
// live in registers; at AFNS5 with the propagation's A (25) and L (15) that
// is more than the 64 registers a thread of a 1,024-thread block may hold, so
// the 1,024-thread instance spills to local memory (-Xptxas -v prints how
// much) and a 256-thread instance serves P ≤ 256, the estimate_sv batch.
// The draw's parameter row sits in shared memory and the panel is read
// through the read-only path: both are the same address for every thread
// (broadcasts).  normals[d, t, :] is read once per step, one coalesced row;
// the draw stride may be 0 (estimate_sv hands every draw one noise pair).
// The logsumexp (max, then Σ exp) and the ESS (Σ w²) are block reductions:
// a butterfly in each warp, then every thread sums the warps' partials in
// warp order from shared memory, so the result is the same on every thread
// and deterministic.  Resampling (block-uniform: every thread sees the same
// ESS) takes an inclusive block scan of the normalised weights (warp
// shuffles, then the warp totals in order) into shared memory, then per slot
// the first i with cum_i ≥ (j + u_t)/n_eff by binary search — searchsorted-
// left, so u = 0 clones particle 0 — clamped to n_eff − 1, and 2 for a dead
// slot.  After propagation S is lower triangular, so a resampled particle
// moves β, the Ms(Ms+1)/2 lower entries of S and h (21 values at AFNS5)
// through shared memory: 86 KB at P = 1024 in float32, 172 KB in float64,
// under the 227 KB opt-in.
//
// A batch of few draws leaves most SMs idle under one block a draw
// (estimate_sv's step batch, 8 draws: 8 of 132 SMs, each carrying 8 warps
// through every step's chain).  While the batch's clusters fit the card at
// once (cudaOccupancyMaxActiveClusters), a third kernel runs each draw on a
// thread-block cluster instead, its warps on separate SMs, and exchanges the
// draw's sums and resampled states through distributed shared memory in the
// order that returns the block kernel's bits (see fused_pf_cluster_kernel).
//
// Semantics kept exactly: the first innovation is skipped (t > 0); a column
// with any NaN is a predict-only step whose update is computed and blended
// away with a float 0/1; ok = r finite and every f finite and > 0, else the
// particle's step is −Inf; pivots floored at 1e-12 with NaN kept NaN (the
// max is NaN-propagating, as jnp.maximum and torch.clamp); the block max is
// NaN-propagating too.  Built with FMA contraction (nvcc's default): the
// float64 kernel agrees with its plain version at rtol 1e-9 and on the −Inf
// draws (chip_smoke.py phase 12), and no sentinel here rests on a product
// rounding to zero.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr double kLog2Pi = 1.8378770664093453;  // log(2π)
constexpr double kPivotFloor = 1e-12;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

// max(s, fl) with a NaN s kept (jnp.maximum; fl is never NaN)
template <typename R>
__device__ __forceinline__ R floor_max(R s, R fl) {
  return (s != s) ? s : (s > fl ? s : fl);
}

// NaN-propagating max (jnp.max, torch.amax)
template <typename R>
__device__ __forceinline__ R nan_max(R a, R b) {
  R r = a > b ? a : b;
  r = (b != b) ? b : r;
  return (a != a) ? a : r;  // selects, no branches: a NaN a first, then b
}

// Stage clocks (built only with -DYFM_PF_CLOCKS, as its own library that
// chip_smoke.py alone loads): clock64() stamps between the stages of a step,
// each stage's cycles summed over the steps, written by thread 0 of draw 0.
enum Stage {
  kUpdates,    // the log-vol proposal and the N Potter updates
  kPropagate,  // the blend of a predict-only column and the propagation
  kBarrier,    // the cluster kernel: the step's publishing stores, the cluster
               // barrier and the wait at it
  kMax,        // the weights' max (the cluster kernel: with the DSMEM loads)
  kSum,        // Σ exp, the step's loglik and the new log-weights
  kEss,        // a contributing step's ESS
  kScan,       // a resampling step's scan of the weights
  kSearch,     // its search for each slot's source
  kGather,     // its move of the source's state
  kLoopTop,    // from the last stage of a step to the next step's start: the
               // loop's own cost and one stamp
  kStages
};
// clocks[] after the stages: steps, contributing steps, resampling steps,
// the loop's cycles; the SM of each CTA of draw 0 (block: CTA 0 alone); then
// the cluster kernel's helper warp: its stages and its cycles waiting for the
// chain warp's hand-off
constexpr int kClockSteps = kStages, kClockSms = kStages + 4, kClockHelper = kClockSms + 16,
              kClockSlots = kClockHelper + kStages + 1;

#ifdef YFM_PF_CLOCKS
struct Clock {
  long long last, acc[kStages], waited;
  int contrib, resampled;
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int s = 0; s < kStages; ++s) acc[s] = 0;
    waited = 0;
    contrib = resampled = 0;
    last = clock64();
  }
  __device__ __forceinline__ void stamp(Stage s) {
    const long long c = clock64();
    acc[s] += c - last;
    last = c;
  }
  __device__ __forceinline__ long long now() const { return clock64(); }
  __device__ __forceinline__ void add_wait(long long since) { waited += clock64() - since; }
  __device__ __forceinline__ void note(bool contributed, bool resampled_now) {
    contrib += contributed;
    resampled += resampled_now;
  }
  __device__ void write(long long* clocks, int steps) const {
    long long loop = 0;
    for (int s = 0; s < kStages; ++s) {
      clocks[s] = acc[s];
      loop += acc[s];
    }
    clocks[kClockSteps] = steps;
    clocks[kClockSteps + 1] = contrib;
    clocks[kClockSteps + 2] = resampled;
    clocks[kClockSteps + 3] = loop;
  }
  __device__ void write_helper(long long* clocks) const {
    for (int s = 0; s < kStages; ++s) clocks[kClockHelper + s] = acc[s];
    clocks[kClockHelper + kStages] = waited;
  }
};
__device__ __forceinline__ void write_sm(long long* clocks, int rank) {
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  if (rank < 16) clocks[kClockSms + rank] = sm;
}
#else
struct Clock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void stamp(Stage) {}
  __device__ __forceinline__ long long now() const { return 0; }
  __device__ __forceinline__ void add_wait(long long) {}
  __device__ __forceinline__ void note(bool, bool) {}
  __device__ __forceinline__ void write(long long*, int) const {}
  __device__ __forceinline__ void write_helper(long long*) const {}
};
__device__ __forceinline__ void write_sm(long long*, int) {}
#endif

// Sum (MAX = false) or NaN-propagating max over the block, the same value
// on every thread: a butterfly per warp, then every thread combines the
// warps' partials in warp order.  Two barriers; ``scratch`` holds 32.
template <typename R, bool MAX>
__device__ __forceinline__ R block_reduce(R v, R* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const R o = __shfl_xor_sync(kFull, v, off);
    v = MAX ? nan_max(v, o) : v + o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  R r = scratch[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    r = MAX ? nan_max(r, scratch[w]) : r + scratch[w];
  __syncthreads();
  return r;
}

// The log-vol proposal h' = φ_h h + σ_h z with σ_h z rounded first and
// φ_h h fused into the sum, written out: left to the compiler's contraction,
// two call sites of one expression fused different products.
template <typename R>
__device__ __forceinline__ R propose_h(R svphi, R h, R svsig, R nzv) {
  return fma(svphi, h, svsig * nzv);
}

// The draw's parameter row (``rows`` (D, npar)): [Z (N·Ms, row-major) | d (N)
// | Φ (Ms², row-major) | δ (Ms) | Ω (Ms²) | σ² | β₀ (Ms) | S₀ (Ms²) | φ_h |
// σ_h], and the offsets of its parts.
template <int MS>
struct Row {
  int o_d, o_phi, o_del, o_om, o_ov, o_b0, o_s0, o_svp, o_svs;
  __device__ explicit Row(int N)
      : o_d(N * MS), o_phi(o_d + N), o_del(o_phi + MS * MS), o_om(o_del + MS),
        o_ov(o_om + MS * MS), o_b0(o_ov + 1), o_s0(o_b0 + MS), o_svp(o_s0 + MS * MS),
        o_svs(o_svp + 1) {}
};

// The pieces of one particle's step for the cluster kernel, which runs the
// S side and the β side on two warps: each expression as advance() below
// writes it (the same roundings, so the same bits), advance() keeping its
// own instruction order for the block kernels (grouping S before β cost the
// 1,024-thread instance 6%).
//
// The S side of one Potter update: φ = Sᵀz, f = φᵀφ + r with its guard, Sφ,
// α = 1/(f + √r√f) and the downdate S −= α Sφφᵀ.  Leaves f (guarded) and Sφ
// for the β side; clears ``ok`` where f is not finite or not > 0.
template <typename R, int MS>
__device__ __forceinline__ void update_S(R (&Su)[MS * MS], const R (&z)[MS], R r, R sqrt_r,
                                         R& fsafe, R (&Sphi)[MS], bool& ok) {
  R phi[MS];  // Sᵀz
#pragma unroll
  for (int m = 0; m < MS; ++m) {
    R s = R(0);
#pragma unroll
    for (int k = 0; k < MS; ++k) s += Su[k * MS + m] * z[k];
    phi[m] = s;
  }
  R f = R(0);
#pragma unroll
  for (int m = 0; m < MS; ++m) f += phi[m] * phi[m];
  f += r;
  fsafe = f > R(0) ? f : R(1);
  ok = ok && isfinite(f) && f > R(0);
#pragma unroll
  for (int k = 0; k < MS; ++k) {  // P z
    R s = R(0);
#pragma unroll
    for (int m = 0; m < MS; ++m) s += Su[k * MS + m] * phi[m];
    Sphi[k] = s;
  }
  const R alpha = R(1) / (fsafe + sqrt_r * dsqrt(fsafe));
#pragma unroll
  for (int k = 0; k < MS; ++k) {
#pragma unroll
    for (int m = 0; m < MS; ++m) Su[k * MS + m] -= alpha * (Sphi[k] * phi[m]);
  }
}

// The β side of the same update: v = y − d − βᵀz (y as 0 where it is not
// finite), β += Sφ v/f and the log-likelihood term.
template <typename R, int MS>
__device__ __forceinline__ void update_beta(R (&bu)[MS], const R (&z)[MS], R y, bool fin, R d,
                                            R fsafe, const R (&Sphi)[MS], R& llp) {
  const R half = R(0.5), log2pi = R(kLog2Pi);
  const R lg = dlog(fsafe);  // first: its latency runs under βᵀz and v
  R bz = R(0);
#pragma unroll
  for (int m = 0; m < MS; ++m) bz += bu[m] * z[m];
  const R v = ((fin ? y : R(0)) - d) - bz;
  const R vf = v / fsafe;
#pragma unroll
  for (int m = 0; m < MS; ++m) bu[m] += Sphi[m] * vf;
  llp -= half * (lg + v * v / fsafe + log2pi);
}

// The blend of a predict-only column (a float 0/1 ``obs_f``) and β' = δ + Φβ.
template <typename R, int MS>
__device__ __forceinline__ void propagate_beta(R (&beta)[MS], R (&bu)[MS], R obs_f,
                                               const R* prow, const Row<MS>& o) {
#pragma unroll
  for (int m = 0; m < MS; ++m) bu[m] = beta[m] + (bu[m] - beta[m]) * obs_f;
#pragma unroll
  for (int m = 0; m < MS; ++m) {
    R s = R(0);
#pragma unroll
    for (int k = 0; k < MS; ++k) s += prow[o.o_phi + m * MS + k] * bu[k];
    beta[m] = prow[o.o_del + m] + s;
  }
}

// The blend and S' = chol(ΦS(ΦS)ᵀ + Ω), lower triangular, pivots floored.
template <typename R, int MS>
__device__ __forceinline__ void propagate_S(R (&S)[MS * MS], R (&Su)[MS * MS], R obs_f,
                                            const R* prow, const Row<MS>& o) {
#pragma unroll
  for (int k = 0; k < MS * MS; ++k) Su[k] = S[k] + (Su[k] - S[k]) * obs_f;
  R A[MS * MS];
#pragma unroll
  for (int i = 0; i < MS; ++i) {
#pragma unroll
    for (int k = 0; k < MS; ++k) {
      R s = R(0);
#pragma unroll
      for (int jj = 0; jj < MS; ++jj) s += prow[o.o_phi + i * MS + jj] * Su[jj * MS + k];
      A[i * MS + k] = s;
    }
  }
  // Ω + AAᵀ of every lower entry first, so that only the earlier columns'
  // products stand between the pivots' square roots and divisions
  R W[MS * MS];
#pragma unroll
  for (int i = 0; i < MS; ++i) {
#pragma unroll
    for (int jj = 0; jj <= i; ++jj) {
      R s = prow[o.o_om + i * MS + jj];
#pragma unroll
      for (int k = 0; k < MS; ++k) s += A[i * MS + k] * A[jj * MS + k];
      W[i * MS + jj] = s;
    }
  }
#pragma unroll
  for (int i = 0; i < MS; ++i) {
#pragma unroll
    for (int jj = 0; jj < MS; ++jj) {
      if (jj > i) {
        S[i * MS + jj] = R(0);
        continue;
      }
      R s = W[i * MS + jj];
#pragma unroll
      for (int k = 0; k < jj; ++k) s -= S[i * MS + k] * S[jj * MS + k];
      S[i * MS + jj] = (i == jj) ? dsqrt(floor_max(s, R(kPivotFloor))) : s / S[jj * MS + jj];
    }
  }
}

// One particle's step t: the log-vol proposal from its normal ``nzv``, the N
// sequential Potter square-root updates, the blend of a predict-only column
// and the propagation β' = δ + Φβ, S' = chol(ΦS(ΦS)ᵀ + Ω).  Updates beta,
// S (lower triangular after it) and h; returns the step's loglik (−Inf where
// it is not ok) and sets ``finite_s`` (every entry of the column finite).
template <typename R, int MS>
__device__ __forceinline__ R advance(R (&beta)[MS], R (&S)[MS * MS], R& h, R nzv,
                                     const R* prow, const Row<MS>& o, const R* yrow,
                                     int N, bool& finite_s, Clock& ck) {
  const R ovar = prow[o.o_ov], svphi = prow[o.o_svp], svsig = prow[o.o_svs];
  const R half = R(0.5), log2pi = R(kLog2Pi);
  // ---- log-vol proposal from the streamed normals
  const R h_new = propose_h(svphi, h, svsig, nzv);
  const R r = ovar * dexp(h_new);
  const R sqrt_r = dsqrt(floor_max(r, R(0)));

  // ---- N sequential Potter square-root updates
  R bu[MS], Su[MS * MS];
#pragma unroll
  for (int m = 0; m < MS; ++m) bu[m] = beta[m];
#pragma unroll
  for (int k = 0; k < MS * MS; ++k) Su[k] = S[k];
  R llp = R(0);
  bool ok = isfinite(r);
  finite_s = true;
  for (int i = 0; i < N; ++i) {
    const R y = __ldg(yrow + i);
    const bool fin = isfinite(y);
    finite_s = finite_s && fin;
    const R* zr = prow + i * MS;
    R z[MS];
#pragma unroll
    for (int m = 0; m < MS; ++m) z[m] = zr[m];
    R phi[MS];  // Sᵀz
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      R s = R(0);
#pragma unroll
      for (int k = 0; k < MS; ++k) s += Su[k * MS + m] * z[k];
      phi[m] = s;
    }
    R f = R(0);
#pragma unroll
    for (int m = 0; m < MS; ++m) f += phi[m] * phi[m];
    f += r;
    const R fsafe = f > R(0) ? f : R(1);
    ok = ok && isfinite(f) && f > R(0);
    R bz = R(0);
#pragma unroll
    for (int m = 0; m < MS; ++m) bz += bu[m] * z[m];
    const R v = ((fin ? y : R(0)) - prow[o.o_d + i]) - bz;
    R Sphi[MS];  // P z
#pragma unroll
    for (int k = 0; k < MS; ++k) {
      R s = R(0);
#pragma unroll
      for (int m = 0; m < MS; ++m) s += Su[k * MS + m] * phi[m];
      Sphi[k] = s;
    }
    const R vf = v / fsafe;
#pragma unroll
    for (int m = 0; m < MS; ++m) bu[m] += Sphi[m] * vf;
    const R alpha = R(1) / (fsafe + sqrt_r * dsqrt(fsafe));
#pragma unroll
    for (int k = 0; k < MS; ++k) {
#pragma unroll
      for (int m = 0; m < MS; ++m) Su[k * MS + m] -= alpha * (Sphi[k] * phi[m]);
    }
    llp -= half * (dlog(fsafe) + v * v / fsafe + log2pi);
  }
  ck.stamp(kUpdates);

  // ---- blend update vs predict-only (float blend)
  const R obs_f = finite_s ? R(1) : R(0);
#pragma unroll
  for (int m = 0; m < MS; ++m) bu[m] = beta[m] + (bu[m] - beta[m]) * obs_f;
#pragma unroll
  for (int k = 0; k < MS * MS; ++k) Su[k] = S[k] + (Su[k] - S[k]) * obs_f;

  // ---- propagate: β' = δ + Φβ, S' = chol(ΦS(ΦS)ᵀ + Ω)
#pragma unroll
  for (int m = 0; m < MS; ++m) {
    R s = R(0);
#pragma unroll
    for (int k = 0; k < MS; ++k) s += prow[o.o_phi + m * MS + k] * bu[k];
    beta[m] = prow[o.o_del + m] + s;
  }
  R A[MS * MS];
#pragma unroll
  for (int i = 0; i < MS; ++i) {
#pragma unroll
    for (int k = 0; k < MS; ++k) {
      R s = R(0);
#pragma unroll
      for (int jj = 0; jj < MS; ++jj) s += prow[o.o_phi + i * MS + jj] * Su[jj * MS + k];
      A[i * MS + k] = s;
    }
  }
#pragma unroll
  for (int i = 0; i < MS; ++i) {
#pragma unroll
    for (int jj = 0; jj < MS; ++jj) {
      if (jj > i) {
        S[i * MS + jj] = R(0);
        continue;
      }
      R s = prow[o.o_om + i * MS + jj];
#pragma unroll
      for (int k = 0; k < MS; ++k) s += A[i * MS + k] * A[jj * MS + k];
#pragma unroll
      for (int k = 0; k < jj; ++k) s -= S[i * MS + k] * S[jj * MS + k];
      S[i * MS + jj] = (i == jj) ? dsqrt(floor_max(s, R(kPivotFloor))) : s / S[jj * MS + jj];
    }
  }
  h = h_new;
  ck.stamp(kPropagate);
  return ok ? llp : R(-INFINITY);
}

// Inclusive warp scan of x (lane order).
template <typename R>
__device__ __forceinline__ R warp_scan(R x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const R y = __shfl_up_sync(kFull, x, off);
    x = lane >= off ? x + y : x;
  }
  return x;
}

// First i in [0, n_eff) with cum_i ≥ pos (searchsorted-left), clamped to
// n_eff − 1.
template <typename R>
__device__ __forceinline__ int search(const R* cum, int n_eff, R pos) {
  int lo = 0, hi = n_eff;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] < pos) lo = mid + 1;
    else hi = mid;
  }
  return lo < n_eff ? lo : n_eff - 1;
}

// One block = one draw, thread j = particle slot j (P ≤ 1024).  ``panel``
// (T, N); ``normals`` and ``uniforms`` at element strides (draw, step), the
// particle axis contiguous; ``out`` (D,).
template <typename R, int MS, int MAXT>
__global__ void __launch_bounds__(MAXT) fused_pf_kernel(
    int N, int T, int n_eff, int npar, long long nz_sd, long long nz_st, long long u_sd,
    long long u_st, R th, R log_uniform, const R* __restrict__ rows,
    const R* __restrict__ panel, const R* __restrict__ normals,
    const R* __restrict__ uniforms, R* __restrict__ out, long long* __restrict__ clocks) {
  constexpr int LOW = MS * (MS + 1) / 2;
  constexpr int RW = MS + LOW + 1;  // what a resampled particle moves
  const int P = blockDim.x;
  const int j = threadIdx.x;
  const int draw = blockIdx.x;
  const bool live = j < n_eff;
  const R neg_inf = R(-INFINITY);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* prow = reinterpret_cast<R*>(smem_raw);
  R* scratch = prow + npar;  // 32
  R* cum = scratch + 32;     // P
  R* buf = cum + P;          // RW × P, value-major

  for (int k = j; k < npar; k += P) prow[k] = rows[(long long)draw * npar + k];
  __syncthreads();
  const Row<MS> o(N);

  R beta[MS], S[MS * MS];
#pragma unroll
  for (int m = 0; m < MS; ++m) beta[m] = prow[o.o_b0 + m];
#pragma unroll
  for (int k = 0; k < MS * MS; ++k) S[k] = prow[o.o_s0 + k];
  R h = R(0);
  R logw = live ? log_uniform : neg_inf;
  R ll_tot = R(0);
  const R* nz = normals + (long long)draw * nz_sd + j;
  Clock ck;
  ck.start();

  for (int t = 0; t < T - 1; ++t) {
    ck.stamp(kLoopTop);
    bool finite_s;
    const R ll_step = advance<R, MS>(beta, S, h, __ldg(nz + (long long)t * nz_st), prow, o,
                                     panel + (long long)t * N, N, finite_s, ck);

    // ---- weights and the loglik accumulation
    const bool contrib = finite_s && t > 0;
    const R logw_new = logw + (contrib ? ll_step : R(0));
    const R m_w = block_reduce<R, true>(logw_new, scratch);
    const R m_safe = m_w > neg_inf ? m_w : R(0);
    ck.stamp(kMax);
    const R sum_e = block_reduce<R, false>(dexp(logw_new - m_safe), scratch);
    const R step_ll = m_safe + dlog(sum_e);
    logw = logw_new - step_ll;
    ck.stamp(kSum);
    if (!contrib) continue;  // block-uniform
    ll_tot += step_ll;

    // ---- ESS-gated systematic resampling
    const R wn = dexp(logw);
    const R ess = R(1) / block_reduce<R, false>(wn * wn, scratch);
    ck.stamp(kEss);
    ck.note(true, ess < th);
    if (!(ess < th)) continue;  // block-uniform: every thread holds the same ess
    const int lane = j & 31, warp = j >> 5;
    const R x = warp_scan(wn);
    if (lane == 31) scratch[warp] = x;
    __syncthreads();
    R base = R(0);
    for (int w = 0; w < warp; ++w) base += scratch[w];
    cum[j] = base + x;
    __syncthreads();
    ck.stamp(kScan);
    const R u = __ldg(uniforms + (long long)draw * u_sd + (long long)t * u_st);
    const R pos = live ? (R(j) + u) / R(n_eff) : R(2);
    const int src = search(cum, n_eff, pos);
    ck.stamp(kSearch);
#pragma unroll
    for (int m = 0; m < MS; ++m) buf[m * P + j] = beta[m];
    {
      int q = MS;
#pragma unroll
      for (int i = 0; i < MS; ++i) {
#pragma unroll
        for (int jj = 0; jj <= i; ++jj) buf[(q++) * P + j] = S[i * MS + jj];
      }
    }
    buf[(RW - 1) * P + j] = h;
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MS; ++m) beta[m] = buf[m * P + src];
    {
      int q = MS;
#pragma unroll
      for (int i = 0; i < MS; ++i) {
#pragma unroll
        for (int jj = 0; jj <= i; ++jj) S[i * MS + jj] = buf[(q++) * P + src];
      }
    }
    h = buf[(RW - 1) * P + src];
    logw = live ? log_uniform : neg_inf;
    ck.stamp(kGather);
  }
  if (j == 0) out[draw] = isfinite(ll_tot) ? ll_tot : neg_inf;
  if (clocks != nullptr && draw == 0 && j == 0) {
    ck.write(clocks, T - 1);
    write_sm(clocks, 0);
  }
}

// More slots than threads (P > 1024): thread j runs slots j, j + 1024, …,
// one after another.  A slot's state between steps — β, the lower triangle
// of S and h, the RW values a resampling moves — and its log-weight live in
// the wrapper's scratch, ``sc`` (D, 2·RW + 2, P): two state buffers (a
// resampling gathers from one into the other), the log-weights and the
// cumulative weights.  Each reduction folds a thread's slots in slot order
// before the block reduction, and the scan runs over the slots 1024 at a
// time, so every sum keeps one order and the run repeats bit for bit.
template <typename R, int MS>
__global__ void __launch_bounds__(1024) fused_pf_multi_kernel(
    int N, int T, int P, int n_eff, int npar, long long nz_sd, long long nz_st,
    long long u_sd, long long u_st, R th, R log_uniform, const R* __restrict__ rows,
    const R* __restrict__ panel, const R* __restrict__ normals,
    const R* __restrict__ uniforms, R* __restrict__ sc, R* __restrict__ out) {
  constexpr int LOW = MS * (MS + 1) / 2;
  constexpr int RW = MS + LOW + 1;
  const int nt = blockDim.x;
  const int j = threadIdx.x;
  const int draw = blockIdx.x;
  const R neg_inf = R(-INFINITY);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* prow = reinterpret_cast<R*>(smem_raw);
  R* scratch = prow + npar;  // 32

  R* cur = sc + (long long)draw * (2 * RW + 2) * P;
  R* nxt = cur + (long long)RW * P;
  R* lw = nxt + (long long)RW * P;
  R* cum = lw + P;

  for (int k = j; k < npar; k += nt) prow[k] = rows[(long long)draw * npar + k];
  __syncthreads();
  const Row<MS> o(N);

  // the state a slot carries between steps, to and from a buffer
  auto load = [&](const R* b, int k, R (&beta)[MS], R (&S)[MS * MS], R& h) {
#pragma unroll
    for (int m = 0; m < MS; ++m) beta[m] = b[(long long)m * P + k];
    int q = MS;
#pragma unroll
    for (int i = 0; i < MS; ++i) {
#pragma unroll
      for (int jj = 0; jj < MS; ++jj)
        S[i * MS + jj] = jj <= i ? b[(long long)(q++) * P + k] : R(0);
    }
    h = b[(long long)(RW - 1) * P + k];
  };
  auto store = [&](R* b, int k, const R (&beta)[MS], const R (&S)[MS * MS], R h) {
#pragma unroll
    for (int m = 0; m < MS; ++m) b[(long long)m * P + k] = beta[m];
    int q = MS;
#pragma unroll
    for (int i = 0; i < MS; ++i) {
#pragma unroll
      for (int jj = 0; jj <= i; ++jj) b[(long long)(q++) * P + k] = S[i * MS + jj];
    }
    b[(long long)(RW - 1) * P + k] = h;
  };

  {
    R beta[MS], S[MS * MS];
#pragma unroll
    for (int m = 0; m < MS; ++m) beta[m] = prow[o.o_b0 + m];
#pragma unroll
    for (int k = 0; k < MS * MS; ++k) S[k] = prow[o.o_s0 + k];
    // the state keeps S's lower triangle: S₀ (factored_init's Cholesky
    // factor, or its 1e-3·I stand-in) is lower triangular
    for (int k = j; k < P; k += nt) {
      store(cur, k, beta, S, R(0));
      lw[k] = k < n_eff ? log_uniform : neg_inf;
    }
  }
  __syncthreads();
  R ll_tot = R(0);
  const R* nz = normals + (long long)draw * nz_sd;
  Clock ck;  // advance()'s stamps; the clock build reports the one-slot kernels alone
  ck.start();

  for (int t = 0; t < T - 1; ++t) {
    bool finite_s = true;
    R m_part = neg_inf;
    for (int k = j; k < P; k += nt) {
      R beta[MS], S[MS * MS], h;
      load(cur, k, beta, S, h);
      const R ll_step = advance<R, MS>(beta, S, h, __ldg(nz + (long long)t * nz_st + k),
                                       prow, o, panel + (long long)t * N, N, finite_s, ck);
      store(cur, k, beta, S, h);
      const bool contrib = finite_s && t > 0;
      const R v = lw[k] + (contrib ? ll_step : R(0));
      lw[k] = v;
      m_part = k == j ? v : nan_max(m_part, v);
    }
    const bool contrib = finite_s && t > 0;  // the column decides: block-uniform
    const R m_w = block_reduce<R, true>(m_part, scratch);
    const R m_safe = m_w > neg_inf ? m_w : R(0);
    R e_part = R(0);
    for (int k = j; k < P; k += nt) e_part += dexp(lw[k] - m_safe);
    const R step_ll = m_safe + dlog(block_reduce<R, false>(e_part, scratch));
    R w_part = R(0);
    for (int k = j; k < P; k += nt) {
      lw[k] = lw[k] - step_ll;
      const R wn = dexp(lw[k]);
      w_part += wn * wn;
    }
    if (!contrib) continue;
    ll_tot += step_ll;

    // ---- ESS-gated systematic resampling over all P slots
    const R ess = R(1) / block_reduce<R, false>(w_part, scratch);
    if (!(ess < th)) continue;
    const int lane = j & 31, warp = j >> 5;
    R run = R(0);  // the weight of the slots before this round's 1,024
    for (int k0 = 0; k0 < P; k0 += nt) {
      const int k = k0 + j;
      const R x = warp_scan(k < P ? dexp(lw[k]) : R(0));
      if (lane == 31) scratch[warp] = x;
      __syncthreads();
      R base = R(0);
      for (int w = 0; w < warp; ++w) base += scratch[w];
      if (k < P) cum[k] = run + (base + x);
      R round = R(0);
      for (int w = 0; w < (nt >> 5); ++w) round += scratch[w];
      run += round;
      __syncthreads();
    }
    const R u = __ldg(uniforms + (long long)draw * u_sd + (long long)t * u_st);
    for (int k = j; k < P; k += nt) {
      const R pos = k < n_eff ? (R(k) + u) / R(n_eff) : R(2);
      const int src = search(cum, n_eff, pos);
      R beta[MS], S[MS * MS], h;
      load(cur, src, beta, S, h);
      store(nxt, k, beta, S, h);
      lw[k] = k < n_eff ? log_uniform : neg_inf;
    }
    __syncthreads();
    R* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (j == 0) out[draw] = isfinite(ll_tot) ? ll_tot : neg_inf;
}

// ---- one draw over a thread-block cluster ----------------------------------
//
// A batch of few draws (estimate_sv's step batch: D = 8 at P = 256) gives
// the block kernel a few SMs, each issuing for P/32 warps through every
// step while the rest of the card idles: at D = 8 a step's ≈20,500 cycles
// are ≈7,000 instructions for each of 8 warps on 4 schedulers (the clock
// build, chip_smoke.py [13]).  Here one draw runs on a cluster of C = P/32
// ≤ 8 CTAs, each on its own SM and holding 32 slots (thread j of CTA r:
// slot 32r + j) in two warps:
// - the chain warp runs the proposal, the S side of the N Potter updates
//   (update_S) and S's propagation: the path each step waits for.  A lone
//   warp is latency-bound there (an update's IEEE divisions and square
//   root each end in a branch no instruction is scheduled across), so the
//   β side's two divisions and its log leave that warp:
// - the helper warp runs the β side (update_beta) behind it, from the
//   guarded f and Sφ that the chain warp hands it through shared memory (a
//   per-lane count, release/acquire), then β's propagation and the weight.
// The chain warp loads the next step's normal, offset and column only after
// its last hand-off: a release waits for every earlier load.
// The draw's sums cross the CTAs through distributed shared memory (DSMEM)
// and return the block kernel's bits, with one cluster barrier a step
// (≈800 cycles on an H100, the probe's reading):
// - before the barrier the helper puts the slot's new log-weight, and on a
//   contributing step each warp its part of the slot's RW state values,
//   into its CTA's shared memory;
// - after it, lane l of each warp reads lane l's log-weight of every CTA g:
//   value g of lane l is the block kernel's warp g, lane l.  The max, Σ exp
//   and ESS sums then run, for each g, block_reduce's butterfly on the same
//   values with the same partners, and the C partials fold in warp order,
//   as block_reduce folds its warps' — so both warps of every CTA hold every
//   sum to the bit, and the resampling scan (warp_scan of each g, the
//   totals added in warp order) gives the block scan's cumulative weights;
// - a resampled slot reads its source slot's state from the source CTA,
//   each warp its own part.
// The weight and state buffers alternate with the step's parity: a CTA
// rewrites one only after the next barrier, which every thread reaches after
// its reads of it.  The hand-off slots are rewritten a step later, after
// that step's barrier, which the helper reaches after reading them.
constexpr int kMaxCluster = 8;  // CTAs a draw: the portable cluster size
constexpr int kMaxVote = 4;     // the chain warp's column vote: N ≤ 128

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
// the chain warp's hand-off count, published after the values it covers
__device__ __forceinline__ void publish_count(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.u32 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)), "r"(v) : "memory");
}
// the count once it reaches v (it may be past v: the helper is behind)
__device__ __forceinline__ int await_count(const int* p, int v) {
  int c;
  do {
    asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];" : "=r"(c) : "r"(
                     (unsigned)__cvta_generic_to_shared(p)) : "memory");
  } while (c < v);
  return c;
}

// block_reduce's butterfly for each of the G groups of a lane, level by
// level so that the groups' shuffles overlap; every group ends with its
// warp partial on every lane.
template <typename R, bool MAX, int G>
__device__ __forceinline__ void warp_reduce_groups(R (&v)[G]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    R o[G];
#pragma unroll
    for (int g = 0; g < G; ++g) o[g] = __shfl_xor_sync(kFull, v[g], off);
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = MAX ? nan_max(v[g], o[g]) : v[g] + o[g];
  }
}

// warp_scan for each of the G groups, level by level.
template <typename R, int G>
__device__ __forceinline__ void warp_scan_groups(R (&x)[G]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    R y[G];
#pragma unroll
    for (int g = 0; g < G; ++g) y[g] = __shfl_up_sync(kFull, x[g], off);
#pragma unroll
    for (int g = 0; g < G; ++g) x[g] = lane >= off ? x[g] + y[g] : x[g];
  }
}

// One cluster = one draw, C = P/32 ≤ 8 CTAs of a chain warp and a helper
// warp, lane j of CTA r = slot 32r + j.  Arguments as fused_pf_kernel's.
template <typename R, int MS>
__global__ void __launch_bounds__(64) fused_pf_cluster_kernel(
    int N, int T, int n_eff, int npar, long long nz_sd, long long nz_st, long long u_sd,
    long long u_st, R th, R log_uniform, const R* __restrict__ rows,
    const R* __restrict__ panel, const R* __restrict__ normals,
    const R* __restrict__ uniforms, R* __restrict__ out, long long* __restrict__ clocks) {
  constexpr int LOW = MS * (MS + 1) / 2;
  constexpr int RW = MS + LOW + 1;  // what a resampled slot moves: β, lower S, h
  constexpr int HAND = MS + 1;      // what an update hands the helper: f, Sφ
  const cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int lane = threadIdx.x & 31;
  const bool chain = threadIdx.x < 32;
  const int j = rank * 32 + lane;
  const int draw = blockIdx.x / C;
  const bool live = j < n_eff;
  const R neg_inf = R(-INFINITY);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* prow = reinterpret_cast<R*>(smem_raw);
  R* lw = prow + npar;                 // 2 × 32 log-weights, by the step's parity
  R* sbuf = lw + 2 * 32;               // 2 × RW × 32 state values, value-major, by parity
  R* hand = sbuf + 2 * RW * 32;          // N × HAND × 32 hand-off values
  R* okv = hand + (size_t)N * HAND * 32;  // 32 flags
  int* count = reinterpret_cast<int*>(okv + 32);  // 32 hand-off counts

  for (int k = threadIdx.x; k < npar; k += 64) prow[k] = rows[(long long)draw * npar + k];
  if (chain) count[lane] = 0;
  __syncthreads();
  const Row<MS> o(N);

  // the chain warp holds S and h, the helper β and the log-weight
  R beta[MS], S[MS * MS];
#pragma unroll
  for (int m = 0; m < MS; ++m) beta[m] = prow[o.o_b0 + m];
#pragma unroll
  for (int k = 0; k < MS * MS; ++k) S[k] = prow[o.o_s0 + k];
  R h = R(0);
  R logw = live ? log_uniform : neg_inf;
  R ll_tot = R(0);
  const R* nz = normals + (long long)draw * nz_sd + j;
  const R ovar = prow[o.o_ov], svphi = prow[o.o_svp], svsig = prow[o.o_svs];
  const R* us = uniforms + (long long)draw * u_sd;
  // a step's normal, offset and column (the chain warp's finite flags),
  // loaded in the step before
  R nz_t = __ldg(nz), u_t = __ldg(us), ycol[kMaxVote];
#pragma unroll
  for (int c = 0; c < kMaxVote; ++c)
    ycol[c] = 32 * c + lane < N ? __ldg(panel + 32 * c + lane) : R(0);
  Clock ck;
  ck.start();

  for (int t = 0; t < T - 1; ++t) {
    ck.stamp(kLoopTop);
    const R nzv = nz_t, u = u_t;
    const R* yrow = panel + (long long)t * N;
    const bool more = t + 2 < T;  // a step follows
    const int base = t * (N + 1);  // the hand-off count before this step
    bool finite_s = true;
    R* lw_t = lw + (t & 1) * 32;
    R* sb_t = sbuf + (t & 1) * RW * 32;
    R logw_new = R(0);
    if (chain) {
      // ---- the proposal and the S side of the N updates, each handed over
      // as it ends (a release, which waits for the stores before it: the
      // next step's loads come after the last); the column's finite flags
      // by one vote
#pragma unroll
      for (int c = 0; c < kMaxVote; ++c)
        if (32 * c < N) finite_s = finite_s && __all_sync(kFull, isfinite(ycol[c]));
      const R h_new = propose_h(svphi, h, svsig, nzv);
      const R r = ovar * dexp(h_new);
      const R sqrt_r = dsqrt(floor_max(r, R(0)));
      R Su[MS * MS];
#pragma unroll
      for (int k = 0; k < MS * MS; ++k) Su[k] = S[k];
      bool ok = isfinite(r);
      R z[MS];  // this update's loadings, the next update's loaded beside it
#pragma unroll
      for (int m = 0; m < MS; ++m) z[m] = prow[m];
      for (int i = 0; i < N; ++i) {
        R zn[MS], Sphi[MS], fsafe;
        const int in = i + 1 < N ? i + 1 : i;
#pragma unroll
        for (int m = 0; m < MS; ++m) zn[m] = prow[in * MS + m];
        update_S<R, MS>(Su, z, r, sqrt_r, fsafe, Sphi, ok);
        R* hd = hand + (size_t)i * HAND * 32 + lane;
        hd[0] = fsafe;
#pragma unroll
        for (int m = 0; m < MS; ++m) hd[(m + 1) * 32] = Sphi[m];
#pragma unroll
        for (int m = 0; m < MS; ++m) z[m] = zn[m];
        publish_count(count + lane, base + i + 1);
      }
      okv[lane] = ok ? R(1) : R(0);
      publish_count(count + lane, base + N + 1);
      if (more) {
        nz_t = __ldg(nz + (long long)(t + 1) * nz_st);
        u_t = __ldg(us + (long long)(t + 1) * u_st);
#pragma unroll
        for (int c = 0; c < kMaxVote; ++c)
          ycol[c] = 32 * c + lane < N ? __ldg(yrow + N + 32 * c + lane) : R(0);
      }
      ck.stamp(kUpdates);
      propagate_S<R, MS>(S, Su, finite_s ? R(1) : R(0), prow, o);
      h = h_new;
      ck.stamp(kPropagate);
      if (finite_s && t > 0) {
        int q = MS;
#pragma unroll
        for (int i = 0; i < MS; ++i) {
#pragma unroll
          for (int jj = 0; jj <= i; ++jj) sb_t[(q++) * 32 + lane] = S[i * MS + jj];
        }
        sb_t[(RW - 1) * 32 + lane] = h;
      }
    } else {
      // ---- the β side of each update as soon as the chain warp hands it
      // over, then β's propagation and the new log-weight
      R bu[MS];
#pragma unroll
      for (int m = 0; m < MS; ++m) bu[m] = beta[m];
      R llp = R(0);
      int seen = base;  // the hand-off count last read: no read while it covers i
      for (int i = 0; i < N; ++i) {
        const R y = __ldg(yrow + i);
        const bool fin = isfinite(y);
        finite_s = finite_s && fin;
        R z[MS], Sphi[MS];
#pragma unroll
        for (int m = 0; m < MS; ++m) z[m] = prow[i * MS + m];
        const R d = prow[o.o_d + i];
        if (seen < base + i + 1) {
          const long long w0 = ck.now();
          seen = await_count(count + lane, base + i + 1);
          ck.add_wait(w0);
        }
        const R* hd = hand + (size_t)i * HAND * 32 + lane;
        const R fsafe = hd[0];
#pragma unroll
        for (int m = 0; m < MS; ++m) Sphi[m] = hd[(m + 1) * 32];
        update_beta<R, MS>(bu, z, y, fin, d, fsafe, Sphi, llp);
      }
      if (more) u_t = __ldg(us + (long long)(t + 1) * u_st);
      ck.stamp(kUpdates);
      propagate_beta<R, MS>(beta, bu, finite_s ? R(1) : R(0), prow, o);
      if (seen < base + N + 1) {
        const long long w0 = ck.now();
        await_count(count + lane, base + N + 1);
        ck.add_wait(w0);
      }
      const R ll_step = okv[lane] != R(0) ? llp : neg_inf;
      logw_new = logw + ((finite_s && t > 0) ? ll_step : R(0));
      lw_t[lane] = logw_new;
      if (finite_s && t > 0) {
#pragma unroll
        for (int m = 0; m < MS; ++m) sb_t[m * 32 + lane] = beta[m];
      }
      ck.stamp(kPropagate);
    }
    const bool contrib = finite_s && t > 0;  // the column decides: cluster-uniform
    __syncwarp();
    cluster_arrive();
    cluster_wait();
    ck.stamp(kBarrier);

    // ---- weights and the loglik accumulation, in both warps: x[g] is the
    // block kernel's warp g, this lane; −inf for g ≥ C, which leaves every
    // fold unchanged (nan_max(r, −inf) = r, r + 0 = r for these
    // non-negative sums)
    R x[kMaxCluster], part[kMaxCluster];
#pragma unroll
    for (int g = 0; g < kMaxCluster; ++g) {
      const R v = cl.map_shared_rank(lw_t, g < C ? g : 0)[lane];
      x[g] = g < C ? v : neg_inf;
      part[g] = x[g];
    }
    warp_reduce_groups<R, true, kMaxCluster>(part);
    R m_w = part[0];
#pragma unroll
    for (int g = 1; g < kMaxCluster; ++g) m_w = nan_max(m_w, part[g]);
    const R m_safe = m_w > neg_inf ? m_w : R(0);
    ck.stamp(kMax);
#pragma unroll
    for (int g = 0; g < kMaxCluster; ++g) part[g] = dexp(x[g] - m_safe);
    warp_reduce_groups<R, false, kMaxCluster>(part);
    R sum_e = part[0];
#pragma unroll
    for (int g = 1; g < kMaxCluster; ++g) sum_e = sum_e + part[g];
    const R step_ll = m_safe + dlog(sum_e);
    logw = logw_new - step_ll;
    ck.stamp(kSum);
    if (!contrib) continue;
    ll_tot += step_ll;

    // ---- ESS-gated systematic resampling
    R wn[kMaxCluster];
#pragma unroll
    for (int g = 0; g < kMaxCluster; ++g) {
      wn[g] = dexp(x[g] - step_ll);
      part[g] = wn[g] * wn[g];
    }
    warp_reduce_groups<R, false, kMaxCluster>(part);
    R sq = part[0];
#pragma unroll
    for (int g = 1; g < kMaxCluster; ++g) sq = sq + part[g];
    const R ess = R(1) / sq;
    ck.stamp(kEss);
    ck.note(true, ess < th);
    if (!(ess < th)) continue;  // cluster-uniform: every thread holds the same ess
    // cum of slot 32g + lane in cum[g], the last of group g in last[g]
    warp_scan_groups<R, kMaxCluster>(wn);
    R cum[kMaxCluster], last[kMaxCluster];
    R base_w = R(0);  // the earlier warps' totals in warp order, as the block scan
#pragma unroll
    for (int g = 0; g < kMaxCluster; ++g) {
      cum[g] = base_w + wn[g];
      base_w += __shfl_sync(kFull, wn[g], 31);
      last[g] = base_w;  // = cum[g] on lane 31: the same sum
    }
    ck.stamp(kScan);
    // search's index from registers: cum is non-decreasing wherever a
    // resampling runs (a scan of weights in [0, 1]), so the count of slots
    // below pos is the count of groups that end below it, times 32, plus
    // the count below it in the next group — found for every group by a
    // halving search over the lanes, with shuffles, and picked by select
    const R pos = live ? (R(j) + u) / R(n_eff) : R(2);
    int below = 0;
#pragma unroll
    for (int g = 0; g < kMaxCluster; ++g) below += (g < C && last[g] < pos) ? 1 : 0;
    int in_g[kMaxCluster];
#pragma unroll
    for (int g = 0; g < kMaxCluster; ++g) in_g[g] = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      R v[kMaxCluster];
#pragma unroll
      for (int g = 0; g < kMaxCluster; ++g) v[g] = __shfl_sync(kFull, cum[g], in_g[g] + step - 1);
#pragma unroll
      for (int g = 0; g < kMaxCluster; ++g) in_g[g] = v[g] < pos ? in_g[g] + step : in_g[g];
    }
    int n_below = 32 * below;
#pragma unroll
    for (int g = 0; g < kMaxCluster; ++g) n_below += g == below ? in_g[g] : 0;
    const int src = n_below < n_eff ? n_below : n_eff - 1;
    ck.stamp(kSearch);
    const R* rs = cl.map_shared_rank(sb_t, src >> 5) + (src & 31);
    if (chain) {
      int q = MS;
#pragma unroll
      for (int i = 0; i < MS; ++i) {
#pragma unroll
        for (int jj = 0; jj <= i; ++jj) S[i * MS + jj] = rs[(q++) * 32];
      }
      h = rs[(RW - 1) * 32];
    } else {
#pragma unroll
      for (int m = 0; m < MS; ++m) beta[m] = rs[m * 32];
    }
    logw = live ? log_uniform : neg_inf;
    ck.stamp(kGather);
  }
  if (!chain && rank == 0 && lane == 0) out[draw] = isfinite(ll_tot) ? ll_tot : neg_inf;
  if (clocks != nullptr && draw == 0 && lane == 0) {
    if (chain) write_sm(clocks, rank);
    if (chain && rank == 0) ck.write(clocks, T - 1);
    if (!chain && rank == 0) ck.write_helper(clocks);
  }
  // no CTA leaves while another may still read its shared memory
  __syncwarp();
  cluster_arrive();
  cluster_wait();
}

// One launch's arguments, as the C entry point takes them.
struct Args {
  int D, N, T, P, n_eff, npar;
  long long nz_sd, nz_st, u_sd, u_st;
  double th, log_uniform;
  const void *rows, *panel, *normals, *uniforms;
  void *scratch, *out;
  long long* clocks;  // stage clocks (the clock build), else null
  cudaStream_t stream;
};

// The launch layouts: kAuto picks by the batch (choose() below).
enum Layout { kAuto = 0, kBlock = 1, kCluster = 2, kMulti = 3 };

template <typename R, int MS, int MAXT>
cudaError_t run(const Args& a) {
  const size_t smem =
      sizeof(R) * ((size_t)a.npar + 32 + (size_t)a.P * (1 + MS + MS * (MS + 1) / 2 + 1));
  auto kernel = fused_pf_kernel<R, MS, MAXT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.D, a.P, smem, a.stream>>>(
      a.N, a.T, a.n_eff, a.npar, a.nz_sd, a.nz_st, a.u_sd, a.u_st, R(a.th), R(a.log_uniform),
      static_cast<const R*>(a.rows), static_cast<const R*>(a.panel),
      static_cast<const R*>(a.normals), static_cast<const R*>(a.uniforms),
      static_cast<R*>(a.out), a.clocks);
  return cudaGetLastError();
}

template <typename R, int MS>
cudaError_t run_multi(const Args& a) {
  if (a.scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = sizeof(R) * ((size_t)a.npar + 32);
  auto kernel = fused_pf_multi_kernel<R, MS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.D, 1024, smem, a.stream>>>(
      a.N, a.T, a.P, a.n_eff, a.npar, a.nz_sd, a.nz_st, a.u_sd, a.u_st, R(a.th),
      R(a.log_uniform), static_cast<const R*>(a.rows), static_cast<const R*>(a.panel),
      static_cast<const R*>(a.normals), static_cast<const R*>(a.uniforms),
      static_cast<R*>(a.scratch), static_cast<R*>(a.out));
  return cudaGetLastError();
}

template <typename R, int MS>
cudaError_t by_block(const Args& a) {
  if (a.P <= 256) return run<R, MS, 256>(a);
  if (a.P <= 1024) return run<R, MS, 1024>(a);
  return run_multi<R, MS>(a);
}

// The cluster launch's configuration: D clusters of C = P/32 two-warp CTAs,
// spread over the SMs; ``attr`` holds its two attributes.
template <typename R, int MS>
cudaError_t cluster_config(const Args& a, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  constexpr int RW = MS + MS * (MS + 1) / 2 + 1;
  const int C = a.P / 32;
  // prow | 2 × 32 weights | 2 × RW × 32 states | N × (Ms + 1) × 32 hand-off
  // values | 32 ok flags | 32 int counts: at most 215 KB (f64, N = 128)
  const size_t smem =
      sizeof(R) * ((size_t)a.npar + 2 * 32 + 2 * RW * 32 + (size_t)a.N * (MS + 1) * 32 + 32) +
      sizeof(int) * 32;
  cudaError_t err = cudaFuncSetAttribute(fused_pf_cluster_kernel<R, MS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(a.D > 0 ? a.D : 1) * C);
  cfg.blockDim = dim3(64);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicySpread;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaSuccess;
}

// Up to 256 slots (at most 8 CTAs, the portable cluster) and 128
// maturities (the chain warp's column vote).
inline bool cluster_fits(const Args& a) { return a.P <= 32 * kMaxCluster && a.N <= 32 * kMaxVote; }

template <typename R, int MS>
cudaError_t by_cluster(const Args& a) {
  if (!cluster_fits(a)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t err = cluster_config<R, MS>(a, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, fused_pf_cluster_kernel<R, MS>, a.N, a.T, a.n_eff, a.npar, a.nz_sd, a.nz_st,
      a.u_sd, a.u_st, R(a.th), R(a.log_uniform), static_cast<const R*>(a.rows),
      static_cast<const R*>(a.panel), static_cast<const R*>(a.normals),
      static_cast<const R*>(a.uniforms), static_cast<R*>(a.out), a.clocks);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of P slots the card holds at once
// (cudaOccupancyMaxActiveClusters), cached by the card, P and the row width.
template <typename R, int MS>
cudaError_t clusters_at_once(const Args& a, int& fit) {
  static int dev_c = -1, P_c = -1, npar_c = -1, fit_c = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev == dev_c && a.P == P_c && a.npar == npar_c) {
    fit = fit_c;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  err = cluster_config<R, MS>(a, cfg, attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&fit, fused_pf_cluster_kernel<R, MS>, &cfg);
  if (err != cudaSuccess) return err;
  dev_c = dev;
  P_c = a.P;
  npar_c = a.npar;
  fit_c = fit;
  return cudaSuccess;
}

// The layout a batch takes: a cluster a draw while the batch's D clusters
// fit the card at once (one wave: the idle SMs are what the clusters buy);
// otherwise a block a draw, which packs several draws on an SM, and above
// 1,024 slots the kernel that runs several slots a thread.
template <typename R, int MS>
cudaError_t choose(const Args& a, int& layout) {
  layout = a.P > 1024 ? kMulti : kBlock;
  if (!cluster_fits(a)) return cudaSuccess;
  int fit = 0;
  cudaError_t err = clusters_at_once<R, MS>(a, fit);
  if (err != cudaSuccess) return err;
  if (a.D <= fit) layout = kCluster;
  return cudaSuccess;
}

template <typename R, int MS>
cudaError_t by_layout(const Args& a, int layout) {
  if (layout == kAuto) {
    cudaError_t err = choose<R, MS>(a, layout);
    if (err != cudaSuccess) return err;
  }
  if (layout == kCluster) return by_cluster<R, MS>(a);
  return by_block<R, MS>(a);
}

template <typename R>
cudaError_t dispatch(int ms, const Args& a, int layout) {
  if (ms == 3) return by_layout<R, 3>(a, layout);
  if (ms == 5) return by_layout<R, 5>(a, layout);
  return cudaErrorInvalidValue;
}

int entry(int dtype, int ms, const Args& a, int layout) {
  if (a.D <= 0) return 0;
  if (a.P % 32 != 0 || a.n_eff <= 0 || a.n_eff > a.P || a.T < 2 || a.N < 1 || layout < kAuto ||
      layout > kCluster)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(ms, a, layout);
  if (dtype == 1) return dispatch<double>(ms, a, layout);
  return cudaErrorInvalidValue;
}

#ifdef YFM_PF_CLOCKS
// Cycles a dependent operation of each class takes on one warp, for the
// latency-chain bound beside K4's probe (yfm_ssd_latencies): log (with the
// add that keeps its argument in range), a shared-memory load, a load from
// another CTA's shared memory (DSMEM) and a cluster barrier, kLatReps in a
// chain between two stamps, in one cluster of 8 CTAs of one warp.
constexpr int kLatReps = 128;
enum LatOp { kLogAdd, kSharedLoad, kRemoteLoad, kClusterBarrier, kLatOps };

template <typename R>
__global__ void pf_latency_kernel(R c, long long* __restrict__ out, int* __restrict__ sink) {
  __shared__ int ring[32];
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x, rank = (int)cl.block_rank();
  ring[lane] = (lane + 1) & 31;
  cl.sync();
  long long cyc[kLatOps];
  R x = c + R(lane) * R(1e-3);
  {
    __syncwarp();
    const long long t0 = clock64();
#pragma unroll
    for (int i = 0; i < kLatReps; ++i) x = dlog(x) + c;
    cyc[kLogAdd] = clock64() - t0;
  }
  int k = lane;
  {
    __syncwarp();
    const long long t0 = clock64();
#pragma unroll
    for (int i = 0; i < kLatReps; ++i) k = ring[k];
    cyc[kSharedLoad] = clock64() - t0;
  }
  {
    const int* remote = cl.map_shared_rank(ring, (rank + 1) % (int)cl.num_blocks());
    __syncwarp();
    const long long t0 = clock64();
#pragma unroll
    for (int i = 0; i < kLatReps; ++i) k = remote[k];
    cyc[kRemoteLoad] = clock64() - t0;
  }
  {
    const long long t0 = clock64();
    for (int i = 0; i < kLatReps; ++i) {
      cluster_arrive();
      cluster_wait();
    }
    cyc[kClusterBarrier] = clock64() - t0;
  }
  if (rank == 0 && lane == 0)
    for (int q = 0; q < kLatOps; ++q) out[q] = cyc[q];
  sink[rank * 32 + lane] = k + (x > R(0) ? 1 : 0);
  cl.sync();  // no CTA leaves while another may still read its ring
}

template <typename R>
cudaError_t latency_probe(R c, long long* out, int* sink, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8);
  cfg.blockDim = dim3(32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 8;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, pf_latency_kernel<R>, c, out, sink);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
#endif

}  // namespace

// dtype 0 = float32, 1 = float64; ms the state dimension (3 or 5); P the
// slots a draw runs (a multiple of 32), n_eff ≤ P of them live; th =
// ess_threshold·n_eff; log_uniform = −log n_eff.  Above 1,024 slots the
// kernel needs ``scratch``, (D, 2·RW + 2, P) in the working type with RW =
// Ms + Ms(Ms+1)/2 + 1; otherwise it may be null.  ``layout`` 0 picks the
// kernel by the batch, 1 forces the block kernels, 2 the cluster kernel.
// Returns the launch's cudaError_t.
extern "C" int yfm_fused_pf(int dtype, int ms, int D, int N, int T, int P, int n_eff,
                            int npar, long long nz_sd, long long nz_st, long long u_sd,
                            long long u_st, double th, double log_uniform, const void* rows,
                            const void* panel, const void* normals, const void* uniforms,
                            void* scratch, void* out, int layout, void* stream) {
  const Args a{D,    N,     T,       P,        n_eff,   npar, nz_sd,   nz_st,
               u_sd, u_st,  th,      log_uniform, rows, panel, normals, uniforms,
               scratch, out, nullptr, static_cast<cudaStream_t>(stream)};
  return entry(dtype, ms, a, layout);
}

// The layout the automatic choice gives a batch (1 block, 2 cluster, 3
// several slots a thread), or −cudaError_t.
extern "C" int yfm_fused_pf_layout(int dtype, int ms, int D, int N, int P, int npar) {
  Args a{};
  a.D = D;
  a.N = N;
  a.P = P;
  a.npar = npar;
  int layout = kAuto;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && ms == 3) err = choose<float, 3>(a, layout);
  if (dtype == 0 && ms == 5) err = choose<float, 5>(a, layout);
  if (dtype == 1 && ms == 3) err = choose<double, 3>(a, layout);
  if (dtype == 1 && ms == 5) err = choose<double, 5>(a, layout);
  return err == cudaSuccess ? layout : -(int)err;
}

#ifdef YFM_PF_CLOCKS
// The same launch with stage clocks: ``clocks`` (kClockSlots,) int64 gets
// draw 0's cycles by stage (thread 0's), the steps, contributing steps,
// resampling steps and loop cycles, then the SM of each of its CTAs.
extern "C" int yfm_fused_pf_clocks(int dtype, int ms, int D, int N, int T, int P, int n_eff,
                                   int npar, long long nz_sd, long long nz_st, long long u_sd,
                                   long long u_st, double th, double log_uniform,
                                   const void* rows, const void* panel, const void* normals,
                                   const void* uniforms, void* scratch, void* out, int layout,
                                   void* clocks, void* stream) {
  const Args a{D,    N,     T,       P,        n_eff,   npar, nz_sd,   nz_st,
               u_sd, u_st,  th,      log_uniform, rows, panel, normals, uniforms,
               scratch, out, static_cast<long long*>(clocks), static_cast<cudaStream_t>(stream)};
  return entry(dtype, ms, a, layout);
}

// One warp's cycles for kLatReps dependent operations of each LatOp into
// ``out`` (kLatOps,) int64, log in the working type; ``sink`` (256,) int32
// keeps the chains alive.
extern "C" int yfm_pf_latencies(int dtype, void* out, void* sink, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* o = static_cast<long long*>(out);
  int* k = static_cast<int*>(sink);
  if (dtype == 0) return latency_probe<float>(2.0f, o, k, st);
  if (dtype == 1) return latency_probe<double>(2.0, o, k, st);
  return cudaErrorInvalidValue;
}
#endif
