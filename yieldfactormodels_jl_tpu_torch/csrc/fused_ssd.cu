// Fused batched score-driven (MSED) loss for Hopper (sm_90a) — K4.
//
// Replaces the Pallas TPU kernel yieldfactormodels_jl_tpu/ops/pallas_ssd.py
// (_kernel, launched by batched_loss through pl.pallas_call): the whole
// T-step score-driven pass of each parameter draw — OLS β̄, the hand-derived
// inner score through the loading build, the EWMA or plain γ step, re-OLS,
// the AR(1) or random-walk γ transition, and −‖y_{t+1} − ŷ‖² over the
// window — in one launch, value only.  The arithmetic is the one written
// out step by step in ops/fused_ssd.py (batched_loss_reference), which is
// what this kernel is held against.
//
// What bounds it.  On the estimation path a launch carries B = 1 (one
// start) or B = 23 (the 22-parameter Nelder–Mead simplex) draws, and the
// A×B grid B = 257: the time is one draw's dependent chain — T steps, each
// two or three loading builds, two 3×3 solves and the inner reverse sweep,
// every one ending in a sum over the N maturities.  Only at B ≳ 16384 draws
// does the card's operation rate bound it.
//
// The design answers the chain.  One warp runs one draw and lane i holds
// maturity i (N > 32 strides lanes, slot k holding maturity lane + 32k: it
// is correct, not fast), so the per-maturity work of a step is one parallel
// pass and every sum over maturities — the six Gram entries and two
// right-hand sides of OLS, Σr2², the sweep's Σō·r2, Σr̄, Σr̄x and the
// eighteen MLP parameter sums, the loss — is a butterfly of __shfl_xor_sync,
// several independent sums sharing each level.  Scalars every lane needs
// (raw₀, raw_{n−2}, raw_{n−1}, y₀) are broadcast by __shfl_sync.  The L γ
// values (18 neural, 1 λ) and their EWMA second moments are carried by
// every lane in registers, and every lane applies the γ step itself: the
// butterfly leaves every score component on every lane, so no broadcast is
// needed after the update, and the L-wide update is a few dozen scalar
// operations next to the maturity work.  A, B, ν, μ and Φ sit in shared
// memory, read as broadcasts.  A step's last loading build is Z(γ) of the
// next step, so it is carried over and each step builds twice (three times
// with AR(1) dynamics), not three (four) times.  A lane-per-draw carry-over
// of the TPU layout would keep ≈200 live values a thread at N = 20 and stay
// serial in N.
//
// Semantics kept exactly: a column is observed by its first entry alone; a
// partially NaN observed column poisons β with NaN; NaN entries enter OLS as
// 0; the EWMA bias correction uses a float count that advances on observed
// steps only; observed on start ≤ t < end, contributing on start ≤ t ≤
// end−2; the loss divided by N·nobs and −Inf where it is not finite.  Built
// without --use_fast_math: sqrt of a negative pivot is NaN (that selects the
// ridge factor), tanh, exp and pow are the IEEE versions.  Built with
// -fmad=false (ops/_build.py): every product is rounded before it is added,
// as in the plain version and the Pallas kernel — on a draw whose recursion
// overflows, contracted multiply-adds gave a finite loss where both give
// NaN and so −Inf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;              // draws per block
constexpr unsigned kFull = 0xffffffffu;

// constants of the JAX package, rounded to the working type where used
constexpr double kEps7 = 1e-7;       // nn_transform._EPS
constexpr double kScale = 0.9610;    // nn_transform._SCALE
constexpr double kRidge = 1e-3;      // linalg.RIDGE
constexpr double kLamFloor = 1e-2;   // loadings.LAMBDA_FLOOR

__device__ __forceinline__ float dtanh(float x) { return tanhf(x); }
__device__ __forceinline__ double dtanh(double x) { return tanh(x); }
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double dpow(double x, double y) { return pow(x, y); }

// K independent sums over the warp, sharing each butterfly level
template <typename R, int K>
__device__ __forceinline__ void warp_sums(R (&v)[K]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
  }
}

template <typename R>
__device__ __forceinline__ R warp_sum(R v) {
  R a[1] = {v};
  warp_sums<R, 1>(a);
  return a[0];
}

// The maturity slots of one lane: slot k holds maturity lane + 32k.
template <typename R, int PL> struct Slots {
  R tau[PL];
  int idx[PL];
  bool on[PL];
};

// value of maturity j, held by one slot of one lane, on every lane
template <typename R, int PL>
__device__ __forceinline__ R at(const Slots<R, PL>& s, const R (&v)[PL], int j) {
  R mine = R(0);
#pragma unroll
  for (int k = 0; k < PL; ++k)
    if (s.idx[k] == j) mine = v[k];
  return __shfl_sync(kFull, mine, j & 31);
}

// Z(γ)'s columns 2 and 3 on the lane's slots, and what the inner sweep
// needs of the forward pass.
template <typename R, bool NEURAL, int PL> struct Build {
  R z2[PL], z3[PL];
  // neural: raw and tanh activations of both nets, slope-transform t, c,
  // curvature-transform r, r2, S and the denominator (or its inverse)
  R raw2[PL], h2[PL][3], raw3[PL], h3[PL][3], t[PL], c, r[PL], r2[PL], sum_sq, d;
  // λ: λ and e^{−λτ}
  R lam, zt[PL];
};

template <typename R, int PL>
__device__ __forceinline__ void mlp(const R* p9, const Slots<R, PL>& s, R (&raw)[PL],
                                    R (&h)[PL][3]) {
#pragma unroll
  for (int k = 0; k < PL; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) h[k][j] = dtanh(p9[j] * s.tau[k] + p9[3 + j]);
    raw[k] = p9[6] * h[k][0] + p9[7] * h[k][1] + p9[8] * h[k][2];
  }
}

template <typename R, bool NEURAL, int PL>
__device__ __forceinline__ void build(Build<R, NEURAL, PL>& b, const R* g,
                                      const Slots<R, PL>& s, int n, bool transformed,
                                      R x1, R dx) {
  if constexpr (!NEURAL) {
    b.lam = R(kLamFloor) + dexp(g[0]);
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      R zt = dexp(-b.lam * s.tau[k]);
      R z2 = (R(1) - zt) / (b.lam * s.tau[k]);
      b.zt[k] = zt;
      b.z2[k] = s.on[k] ? z2 : R(0);
      b.z3[k] = s.on[k] ? z2 - zt : R(0);
    }
  } else {
  mlp<R, PL>(g, s, b.raw2, b.h2);
  mlp<R, PL>(g + 9, s, b.raw3, b.h3);
  // slope curve: interior 1..n−3, entry 0 pinned to 1, n−2 and n−1 to 0
  R rl = R(0);
  if (transformed) {
    R r0 = __shfl_sync(kFull, b.raw2[0], 0);
    rl = at<R, PL>(s, b.raw2, n - 2);
    b.c = R(1) / (r0 - rl + R(kEps7));
  }
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    int i = s.idx[k];
    R sq;
    if (transformed) {
      b.t[k] = (b.raw2[k] - rl) * b.c;
      sq = b.t[k] * b.t[k];
    } else {
      sq = b.raw2[k] * b.raw2[k];
    }
    b.z2[k] = (s.on[k] && i >= 1 && i <= n - 3) ? sq : (i == 0 ? R(1) : R(0));
  }
  // curvature curve: interior 1..n−2, both ends 0, normalised
  R slope = R(0), intercept = R(0);
  if (transformed) {
    R a0 = __shfl_sync(kFull, b.raw3[0], 0);
    R an = at<R, PL>(s, b.raw3, n - 1);
    slope = (an - a0) / dx;
    intercept = a0 - slope * x1;
  }
  R part = R(0);
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    int i = s.idx[k];
    b.r[k] = transformed ? b.raw3[k] - (slope * s.tau[k] - intercept) : b.raw3[k];
    b.r2[k] = (s.on[k] && i >= 1 && i <= n - 2) ? b.r[k] * b.r[k] : R(0);
    part += b.r2[k] * b.r2[k];
  }
  b.sum_sq = warp_sum<R>(part);
  if (transformed) {
    b.d = dsqrt(b.sum_sq) / R(kScale) + R(kEps7);
#pragma unroll
    for (int k = 0; k < PL; ++k) b.z3[k] = b.r2[k] / b.d;
  } else {
    b.d = R(kScale) / dsqrt(b.sum_sq) + R(kEps7);
#pragma unroll
    for (int k = 0; k < PL; ++k) b.z3[k] = b.r2[k] * b.d;
  }
  }
}

// 3×3 Cholesky of the normal equations: the plain factor where all six
// pivots are finite, else the +1e-3 ridge factor (ops/linalg.ols_solve)
template <typename R>
__device__ __forceinline__ void chol3(R g11, R g21, R g22, R g31, R g32, R g33, R (&l)[6]) {
  l[0] = dsqrt(g11);
  l[1] = g21 / l[0];
  l[3] = g31 / l[0];
  l[2] = dsqrt(g22 - l[1] * l[1]);
  l[4] = (g32 - l[3] * l[1]) / l[2];
  l[5] = dsqrt(g33 - l[3] * l[3] - l[4] * l[4]);
}

template <typename R, int PL>
__device__ __forceinline__ void ols(const R (&z2)[PL], const R (&z3)[PL], const R (&ys)[PL],
                                    R sy, int n, R (&beta)[3]) {
  R s[7] = {R(0), R(0), R(0), R(0), R(0), R(0), R(0)};
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    s[0] += z2[k];
    s[1] += z3[k];
    s[2] += z2[k] * z2[k];
    s[3] += z3[k] * z2[k];
    s[4] += z3[k] * z3[k];
    s[5] += z2[k] * ys[k];
    s[6] += z3[k] * ys[k];
  }
  warp_sums<R, 7>(s);
  R g11 = R(n), g21 = s[0], g31 = s[1], g22 = s[2], g32 = s[3], g33 = s[4];
  R l[6], lr[6];
  chol3<R>(g11, g21, g22, g31, g32, g33, l);
  bool ok = true;
#pragma unroll
  for (int q = 0; q < 6; ++q) ok = ok && isfinite(l[q]);
  chol3<R>(g11 + R(kRidge), g21, g22 + R(kRidge), g31, g32, g33 + R(kRidge), lr);
#pragma unroll
  for (int q = 0; q < 6; ++q) l[q] = ok ? l[q] : lr[q];
  const R l11 = l[0], l21 = l[1], l22 = l[2], l31 = l[3], l32 = l[4], l33 = l[5];
  R y1 = sy / l11;
  R y2 = (s[5] - l21 * y1) / l22;
  R y3 = (s[6] - l31 * y1 - l32 * y2) / l33;
  beta[2] = y3 / l33;
  beta[1] = (y2 - l32 * beta[2]) / l22;
  beta[0] = (y1 - l21 * beta[1] - l31 * beta[2]) / l11;
}

// ∇_γ −‖y − Zβ̄‖² with β̄ fixed: the hand-derived reverse sweep through the
// loading build (ops/fused_ssd.py's module docstring has the formulas)
template <typename R, bool NEURAL, int PL, int LM>
__device__ __forceinline__ void score(const Build<R, NEURAL, PL>& b, const R* g,
                                      const Slots<R, PL>& s, const R (&ys)[PL],
                                      const R (&beta)[3], int n, bool transformed, R x1,
                                      R inv_dx, R (&grad)[LM]) {
  R v[PL];
#pragma unroll
  for (int k = 0; k < PL; ++k)
    v[k] = s.on[k] ? ys[k] - (beta[0] + beta[1] * b.z2[k] + beta[2] * b.z3[k]) : R(0);
  if constexpr (!NEURAL) {
    R acc = R(0);
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      if (!s.on[k]) continue;
      R t = s.tau[k], zt = b.zt[k];
      R lt = b.lam * t;
      R dz2 = (zt * t * lt - (R(1) - zt) * t) / (lt * lt);
      R dz3 = dz2 + t * zt;
      acc += R(2) * v[k] * (beta[1] * dz2 + beta[2] * dz3);
    }
    grad[0] = warp_sum<R>(acc) * (b.lam - R(kLamFloor));
  } else {
  R ob2[PL], ob3[PL], rb2[PL], rb3[PL];
  // round 1: the slope transform's two sums and the curvature's Σō·r2
  R r1[3] = {R(0), R(0), R(0)};
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    int i = s.idx[k];
    bool in1 = s.on[k] && i >= 1 && i <= n - 3;
    ob2[k] = R(2) * beta[1] * v[k];
    ob3[k] = R(2) * beta[2] * v[k];
    if (transformed) {
      rb2[k] = in1 ? ob2[k] * R(2) * b.t[k] * b.c : R(0);
      r1[0] += rb2[k];
      r1[1] += in1 ? ob2[k] * R(2) * b.t[k] * b.t[k] * b.c : R(0);
    } else {
      rb2[k] = in1 ? ob2[k] * R(2) * b.raw2[k] : R(0);
    }
    r1[2] += ob3[k] * b.r2[k];
  }
  warp_sums<R, 3>(r1);
  const R s_tc = r1[0], s_t2c = r1[1], dot = r1[2];
  if (transformed) {
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      int i = s.idx[k];
      if (i == 0) rb2[k] = -s_t2c;
      if (i == n - 2) rb2[k] = s_t2c - s_tc;
    }
  }
  // the curvature transform's adjoint; round 2: Σr̄, Σr̄x (transformed)
  if (transformed) {
    R coef = dot / (dsqrt(b.sum_sq) * R(kScale) * b.d * b.d);
    R r2s[2] = {R(0), R(0)};
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      int i = s.idx[k];
      bool in2 = s.on[k] && i >= 1 && i <= n - 2;
      rb3[k] = in2 ? R(2) * b.r[k] * (ob3[k] / b.d - coef * b.r2[k]) : R(0);
      r2s[0] += rb3[k];
      r2s[1] += rb3[k] * s.tau[k];
    }
    warp_sums<R, 2>(r2s);
    R slope_bar = -(r2s[1] + r2s[0] * x1);
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      int i = s.idx[k];
      if (i == 0) rb3[k] = r2s[0] - slope_bar * inv_dx;
      if (i == n - 1) rb3[k] = slope_bar * inv_dx;
    }
  } else {
    R coef = dot * R(kScale) / (b.sum_sq * dsqrt(b.sum_sq));
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      int i = s.idx[k];
      bool in2 = s.on[k] && i >= 1 && i <= n - 2;
      rb3[k] = in2 ? R(2) * b.r[k] * (ob3[k] * b.d - coef * b.r2[k]) : R(0);
    }
  }
  // round 3: the eighteen MLP parameter sums, both nets at once
#pragma unroll
  for (int q = 0; q < 18; ++q) grad[q] = R(0);
#pragma unroll
  for (int k = 0; k < PL; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R h = b.h2[k][j];
      R pre = rb2[k] * g[6 + j] * (R(1) - h * h);
      grad[j] += pre * s.tau[k];
      grad[3 + j] += pre;
      grad[6 + j] += rb2[k] * h;
      h = b.h3[k][j];
      pre = rb3[k] * g[15 + j] * (R(1) - h * h);
      grad[9 + j] += pre * s.tau[k];
      grad[12 + j] += pre;
      grad[15 + j] += rb3[k] * h;
    }
  }
  warp_sums<R, LM>(grad);
  }
}

template <typename R, bool NEURAL, int PL>
__global__ void __launch_bounds__(kWarps * 32)
ssd_loss_kernel(int flags, int B, int n, int T, int start, int end, R ff, R x1, R dx,
                R inv_dx, const R* __restrict__ draws, const R* __restrict__ data,
                const R* __restrict__ mats, R* __restrict__ out) {
  constexpr int LM = NEURAL ? 18 : 1;
  constexpr int W = 4 * LM + 15;  // [A | B | ν | ω | δ | μ | Φ]
  __shared__ R sp[kWarps][W];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int draw = blockIdx.x * kWarps + warp;
  if (draw >= B) return;  // the whole warp: no block-wide barrier follows
  const bool transformed = flags & 2, scale_grad = flags & 4, has_B = flags & 8;

  R* p = sp[warp];
  for (int q = lane; q < W; q += 32) p[q] = draws[(size_t)draw * W + q];
  __syncwarp();
  const R* A = p;
  const R* Bp = p + LM;
  const R* nu = p + 2 * LM;
  const R* mu = p + 4 * LM + 3;
  const R* Phi = p + 4 * LM + 6;

  Slots<R, PL> s;
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    s.idx[k] = lane + 32 * k;
    s.on[k] = s.idx[k] < n;
    s.tau[k] = s.on[k] ? mats[s.idx[k]] : R(0);
  }

  R gamma[LM], ewma[LM], grad[LM];
#pragma unroll
  for (int l = 0; l < LM; ++l) {
    gamma[l] = p[3 * LM + l];
    ewma[l] = R(0);
  }
  R beta[3] = {p[4 * LM], p[4 * LM + 1], p[4 * LM + 2]};
  R count = R(0), loss = R(0);
  const R one_m_ff = R(1) - ff;
  const R eps = R(sizeof(R) == 4 ? 1.1920928955078125e-07 : 2.220446049250313e-16);
  const R nan = R(NAN);

  Build<R, NEURAL, PL> bd;
  build<R, NEURAL, PL>(bd, gamma, s, n, transformed, x1, dx);  // Z(γ₀)

  R y[PL];
#pragma unroll
  for (int k = 0; k < PL; ++k) y[k] = s.on[k] ? data[s.idx[k]] : R(0);

  for (int t = 0; t < T - 1; ++t) {
    R ys[PL], yn[PL], sy_part = R(0);
    bool fin = true;
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      bool f = isfinite(y[k]);
      fin = fin && (f || !s.on[k]);
      ys[k] = (s.on[k] && f) ? y[k] : R(0);
      sy_part += ys[k];
      yn[k] = s.on[k] ? data[(size_t)(t + 1) * n + s.idx[k]] : R(0);
    }
    const bool fin0 = __shfl_sync(kFull, (int)isfinite(y[0]), 0);
    const bool all_fin = __all_sync(kFull, fin);
    const bool obs = start <= t && t < end && fin0;

    R beta_obs[3] = {beta[0], beta[1], beta[2]};
    if (obs) {
      const R sy = warp_sum<R>(sy_part);
      R b_ols[3];
      ols<R, PL>(bd.z2, bd.z3, ys, sy, n, b_ols);
      score<R, NEURAL, PL, LM>(bd, gamma, s, ys, b_ols, n, transformed, x1, inv_dx, grad);
      if (scale_grad) {
        count = count + R(1);
        const R denom = R(1) - dpow(ff, count);
#pragma unroll
        for (int l = 0; l < LM; ++l) {
          ewma[l] = ff * ewma[l] + one_m_ff * grad[l] * grad[l];
          gamma[l] = gamma[l] + grad[l] / (dsqrt(ewma[l] / denom) + eps) * A[l];
        }
      } else {
#pragma unroll
        for (int l = 0; l < LM; ++l) gamma[l] = gamma[l] + grad[l] * A[l];
      }
      build<R, NEURAL, PL>(bd, gamma, s, n, transformed, x1, dx);  // Z(γ_obs)
      ols<R, PL>(bd.z2, bd.z3, ys, sy, n, beta_obs);
      if (!all_fin) {
#pragma unroll
        for (int m = 0; m < 3; ++m) beta_obs[m] = beta_obs[m] * nan;
      }
    }
    // transition: γ ← ν + B⊙γ and Z(γ_next), or the random walk's carry
    if (has_B) {
#pragma unroll
      for (int l = 0; l < LM; ++l) gamma[l] = nu[l] + Bp[l] * gamma[l];
      build<R, NEURAL, PL>(bd, gamma, s, n, transformed, x1, dx);
    }
#pragma unroll
    for (int m = 0; m < 3; ++m)
      beta[m] = mu[m] + (Phi[3 * m] * beta_obs[0] + Phi[3 * m + 1] * beta_obs[1] +
                         Phi[3 * m + 2] * beta_obs[2]);
    if (start <= t && t <= end - 2) {
      R sq = R(0);
#pragma unroll
      for (int k = 0; k < PL; ++k) {
        if (!s.on[k]) continue;
        R pv = yn[k] - (beta[0] + beta[1] * bd.z2[k] + beta[2] * bd.z3[k]);
        sq += pv * pv;
      }
      loss = loss + -warp_sum<R>(sq);
    }
#pragma unroll
    for (int k = 0; k < PL; ++k) y[k] = yn[k];
  }
  if (lane == 0) {
    R l = loss / R(n) / R(end - start);
    out[draw] = isfinite(l) ? l : R(-INFINITY);
  }
}

template <typename R, bool NEURAL, int PL>
cudaError_t run(int flags, int B, int n, int T, int start, int end, double ff, double x1,
                double dx, double inv_dx, const void* draws, const void* data,
                const void* mats, void* out, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  ssd_loss_kernel<R, NEURAL, PL><<<blocks, kWarps * 32, 0, stream>>>(
      flags, B, n, T, start, end, R(ff), R(x1), R(dx), R(inv_dx),
      static_cast<const R*>(draws), static_cast<const R*>(data),
      static_cast<const R*>(mats), static_cast<R*>(out));
  return cudaGetLastError();
}

template <typename R>
cudaError_t dispatch(int flags, int L, int B, int n, int T, int start, int end, double ff,
                     double x1, double dx, double inv_dx, const void* draws,
                     const void* data, const void* mats, void* out, cudaStream_t st) {
  const bool neural = flags & 1;
  if (neural != (L == 18) || (!neural && L != 1) || n < 3 || n > 128 || T < 2)
    return cudaErrorInvalidValue;
  if (n <= 32) {
    if (neural)
      return run<R, true, 1>(flags, B, n, T, start, end, ff, x1, dx, inv_dx, draws, data,
                             mats, out, st);
    return run<R, false, 1>(flags, B, n, T, start, end, ff, x1, dx, inv_dx, draws, data,
                            mats, out, st);
  }
  if (neural)
    return run<R, true, 4>(flags, B, n, T, start, end, ff, x1, dx, inv_dx, draws, data,
                           mats, out, st);
  return run<R, false, 4>(flags, B, n, T, start, end, ff, x1, dx, inv_dx, draws, data,
                          mats, out, st);
}

}  // namespace

// dtype 0 = float32, 1 = float64; flags: 1 neural, 2 transformed, 4 EWMA
// scale_grad, 8 AR(1) γ dynamics.  draws (B, 4L+15) draw-major, data (T, N),
// mats (N,), out (B,).  Returns the launch's cudaError_t.
extern "C" int yfm_fused_ssd(int dtype, int flags, int L, int B, int n, int T, int start,
                             int end, double ff, double x1, double dx, double inv_dx,
                             const void* draws, const void* data, const void* mats,
                             void* out, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(flags, L, B, n, T, start, end, ff, x1, dx, inv_dx, draws, data,
                           mats, out, st);
  if (dtype == 1)
    return dispatch<double>(flags, L, B, n, T, start, end, ff, x1, dx, inv_dx, draws, data,
                            mats, out, st);
  return cudaErrorInvalidValue;
}
