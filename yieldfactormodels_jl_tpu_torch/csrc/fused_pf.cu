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
// Semantics kept exactly: the first innovation is skipped (t > 0); a column
// with any NaN is a predict-only step whose update is computed and blended
// away with a float 0/1; ok = r finite and every f finite and > 0, else the
// particle's step is −Inf; pivots floored at 1e-12 with NaN kept NaN (the
// max is NaN-propagating, as jnp.maximum and torch.clamp); the block max is
// NaN-propagating too.  Built with FMA contraction (nvcc's default): the
// float64 kernel agrees with its plain version at rtol 1e-9 and on the −Inf
// draws (chip_smoke.py phase 12), and no sentinel here rests on a product
// rounding to zero.

#include <cuda_runtime.h>
#include <math.h>

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
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

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

// One particle's step t: the log-vol proposal from its normal ``nzv``, the N
// sequential Potter square-root updates, the blend of a predict-only column
// and the propagation β' = δ + Φβ, S' = chol(ΦS(ΦS)ᵀ + Ω).  Updates beta,
// S (lower triangular after it) and h; returns the step's loglik (−Inf where
// it is not ok) and sets ``finite_s`` (every entry of the column finite).
template <typename R, int MS>
__device__ __forceinline__ R advance(R (&beta)[MS], R (&S)[MS * MS], R& h, R nzv,
                                     const R* prow, const Row<MS>& o, const R* yrow,
                                     int N, bool& finite_s) {
  const R ovar = prow[o.o_ov], svphi = prow[o.o_svp], svsig = prow[o.o_svs];
  const R half = R(0.5), log2pi = R(kLog2Pi);
  // ---- log-vol proposal from the streamed normals
  const R h_new = svphi * h + svsig * nzv;
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
  return ok ? llp : R(-INFINITY);
}

// Inclusive warp scan of x (lane order).
template <typename R>
__device__ __forceinline__ R warp_scan(R x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const R y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
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
    const R* __restrict__ uniforms, R* __restrict__ out) {
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

  for (int t = 0; t < T - 1; ++t) {
    bool finite_s;
    const R ll_step = advance<R, MS>(beta, S, h, __ldg(nz + (long long)t * nz_st), prow, o,
                                     panel + (long long)t * N, N, finite_s);

    // ---- weights and the loglik accumulation
    const bool contrib = finite_s && t > 0;
    const R logw_new = logw + (contrib ? ll_step : R(0));
    const R m_w = block_reduce<R, true>(logw_new, scratch);
    const R m_safe = m_w > neg_inf ? m_w : R(0);
    const R sum_e = block_reduce<R, false>(dexp(logw_new - m_safe), scratch);
    const R step_ll = m_safe + dlog(sum_e);
    logw = logw_new - step_ll;
    if (!contrib) continue;  // block-uniform
    ll_tot += step_ll;

    // ---- ESS-gated systematic resampling
    const R wn = dexp(logw);
    const R ess = R(1) / block_reduce<R, false>(wn * wn, scratch);
    if (!(ess < th)) continue;  // block-uniform: every thread holds the same ess
    const int lane = j & 31, warp = j >> 5;
    const R x = warp_scan(wn);
    if (lane == 31) scratch[warp] = x;
    __syncthreads();
    R base = R(0);
    for (int w = 0; w < warp; ++w) base += scratch[w];
    cum[j] = base + x;
    __syncthreads();
    const R u = __ldg(uniforms + (long long)draw * u_sd + (long long)t * u_st);
    const R pos = live ? (R(j) + u) / R(n_eff) : R(2);
    const int src = search(cum, n_eff, pos);
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
  }
  if (j == 0) out[draw] = isfinite(ll_tot) ? ll_tot : neg_inf;
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

  for (int t = 0; t < T - 1; ++t) {
    bool finite_s = true;
    R m_part = neg_inf;
    for (int k = j; k < P; k += nt) {
      R beta[MS], S[MS * MS], h;
      load(cur, k, beta, S, h);
      const R ll_step = advance<R, MS>(beta, S, h, __ldg(nz + (long long)t * nz_st + k),
                                       prow, o, panel + (long long)t * N, N, finite_s);
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

// One launch's arguments, as the C entry point takes them.
struct Args {
  int D, N, T, P, n_eff, npar;
  long long nz_sd, nz_st, u_sd, u_st;
  double th, log_uniform;
  const void *rows, *panel, *normals, *uniforms;
  void *scratch, *out;
  cudaStream_t stream;
};

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
      static_cast<R*>(a.out));
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

template <typename R>
cudaError_t dispatch(int ms, const Args& a) {
  if (ms == 3) return by_block<R, 3>(a);
  if (ms == 5) return by_block<R, 5>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype 0 = float32, 1 = float64; ms the state dimension (3 or 5); P the
// slots a draw runs (a multiple of 32), n_eff ≤ P of them live; th =
// ess_threshold·n_eff; log_uniform = −log n_eff.  Above 1,024 slots the
// kernel needs ``scratch``, (D, 2·RW + 2, P) in the working type with RW =
// Ms + Ms(Ms+1)/2 + 1; otherwise it may be null.  Returns the launch's
// cudaError_t.
extern "C" int yfm_fused_pf(int dtype, int ms, int D, int N, int T, int P, int n_eff,
                            int npar, long long nz_sd, long long nz_st, long long u_sd,
                            long long u_st, double th, double log_uniform, const void* rows,
                            const void* panel, const void* normals, const void* uniforms,
                            void* scratch, void* out, void* stream) {
  if (D <= 0) return 0;
  if (P % 32 != 0 || n_eff <= 0 || n_eff > P || T < 2 || N < 1) return cudaErrorInvalidValue;
  const Args a{D,  N,  T,     P,     n_eff, npar,     nz_sd,    nz_st, u_sd,
               u_st, th, log_uniform, rows, panel, normals, uniforms, scratch, out,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(ms, a);
  if (dtype == 1) return dispatch<double>(ms, a);
  return cudaErrorInvalidValue;
}
