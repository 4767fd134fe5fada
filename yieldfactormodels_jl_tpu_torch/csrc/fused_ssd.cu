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
// start: 9,582 of the 9,745 launches of a 1SSD-NNS estimate_steps at N =
// 20, T = 360), 23 (the simplex) or 257 (the A×B grid) draws, and the time
// is one draw's dependent chain: T − 1 steps of OLS β̄ → the inner score →
// the γ step → Z(γ_obs) → (AR(1)) Z(γ_next), every stage ending in sums
// over the N maturities.  Only at B ≳ 16384 does the card's operation rate
// bound it.  One warp issues in order, about 4 cycles an instruction here,
// so a step costs roughly its instruction count times 4.  chip_smoke.py
// [10] stamps the stages with clock64() in a build of this file with
// -DYFM_SSD_CLOCKS (1SSD-NNS, float32, N = 20, one draw, H100): the one-
// warp design this replaces took 10,851 cycles a step — the γ step 3,615
// (every lane ran all 18 EWMA updates: 18 sqrt and 36 divides, and
// powf(ff, count)), OLS 1,406 and 1,294 (both Cholesky factors, always,
// after a 7-sum butterfly), the loading builds 1,406 and 1,340, the score
// 1,347 (three butterflies, the last over 18 sums), the loss 276.  The
// dependent path alone, at the latencies a probe in the same build
// measures (div 57, sqrt 55, tanh 62, shuffle 24, add 4.6 cycles), is
// ≈2,470 cycles a step: 0.447 ms for the whole pass at 1,980 MHz.
//
// The design, stage by stage (cycles a step after the redesign, same
// measurement):
// - γ step (3,615 → ≈390): each of the 18 components lives on one lane,
//   the one the score's reduce-scatter leaves its sum on, with its EWMA
//   moment, A, ν and B in registers: one sqrt and two divides a lane.  The
//   new γ goes to the draw's row in shared memory, which the builds read.
//   1 − ff^count comes from a table of the next 32 counts, one a lane,
//   filled every 32 observed steps and read by a shuffle.
// - score (1,347 → ≈1,210): the eighteen MLP parameter sums by recursive
//   halving (20 shuffles, not 90); rounds 1 and 2 stay butterflies (every
//   lane needs those sums).
// - OLS (1,406 → ≈850): the plain Cholesky factor, and the ridge one only
//   when a pivot is not finite (warp-uniform: every lane holds the same
//   sums).  Its sums ride in the build's reductions — Σz₂, Σz₂², Σz₂y, Σy
//   with the curvature transform's Σr2², the four that need z₃ in one more
//   after it — each a reduce-scatter and a broadcast from the owning lane
//   (fewer instructions than a butterfly from four sums on).
// - the re-OLS, β ← μ + Φβ and the loss (≈1,115 in line) go to a second,
//   helper warp per draw, one step behind: at the end of each step the
//   chain warp leaves the re-OLS sums and Z(γ_next) in shared memory and
//   arrives on a named barrier; the helper waits there, copies them,
//   arrives on a second barrier that frees the buffer, and works while the
//   chain runs the next step.  The handoff costs the chain ≈110 cycles.
//   Beyond one wave of resident draw pairs (an occupancy query at launch)
//   the helpers would halve the draws an SM holds, so there the chain warp
//   runs the tail itself in a one-warp launch of the same code.
// - the head's finite flags of the next column are read after the observed
//   part of the step, which hides the column's load.
// - builds (≈2,000 each, with OLS's sums): the largest stage now,
//   and what sets the pace; each lane runs 6 IEEE tanh for the two
//   1→3→1 nets, 4 divides and a sqrt, and two reductions.  The two nets on
//   separate warps would halve the tanh a lane, at two more barriers a
//   build: not tried.
// The float32 step went from 10,851 to ≈6,750 cycles.
//
// Bits.  Every sum keeps the butterfly's pairing — recursive halving pairs
// the same partners, each lane adding its own partial first — and every
// expression its order, so the kernel returns the one-warp design's bits in
// both types (chip_smoke.py [11] repeats the Nelder–Mead path of a
// 1SSD-NNS estimate_steps launch for launch).  Lane i holds maturity i
// (N > 32 strides lanes, slot k holding maturity lane + 32k: it is correct,
// not fast).  A step's last loading build is Z(γ) of the next step, so it
// is carried over and each step builds twice (three times with AR(1)
// dynamics), not three (four) times.
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

constexpr int kDraws = 4;              // draws per block, two warps each
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

// K independent sums over the warp, sharing each butterfly level; every
// lane ends with the same bits (each level adds a pair in both orders)
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

// Named barriers between a draw's two warps (64 threads): the producer
// arrives, the consumer waits; either orders the shared-memory accesses
// before it for the other.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// One level of recursive halving: lanes with bit ``off`` clear keep the
// first H of the C partial sums, the others the rest (zero-padded), each
// adding its partner's copy.
template <typename R, int C, int H>
__device__ __forceinline__ void halve(const R (&v)[C], R (&out)[H], int off) {
  const bool up = (threadIdx.x & off) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const R lo = v[k];
    const R hi = H + k < C ? v[H + k] : R(0);
    out[k] = (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, off);
  }
}

// Reduce-scatter of C ≤ 32 sums over the warp: the lane returns the whole
// sum of component ``scatter_component(C, lane)`` (or a padding zero), in
// ⌈C/2⌉ + ⌈C/4⌉ + … shuffles where a butterfly takes 5C.
template <typename R, int C>
__device__ __forceinline__ R warp_reduce_scatter(const R (&v)[C]) {
  constexpr int H1 = (C + 1) / 2, H2 = (H1 + 1) / 2, H3 = (H2 + 1) / 2;
  constexpr int H4 = (H3 + 1) / 2, H5 = (H4 + 1) / 2;
  static_assert(H5 == 1, "at most 32 components");
  R a[H1], b[H2], c[H3], d[H4], e[H5];
  halve<R, C, H1>(v, a, 16);
  halve<R, H1, H2>(a, b, 8);
  halve<R, H2, H3>(b, c, 4);
  halve<R, H3, H4>(c, d, 2);
  halve<R, H4, H5>(d, e, 1);
  return e[0];
}

// The component whose sum warp_reduce_scatter<C> leaves on ``lane``, −1 for
// a padding lane.
__host__ __device__ constexpr int scatter_component(int C, int lane) {
  int size = C, base = 0, real = C;
  for (int off = 16; off > 0; off >>= 1) {
    const int h = (size + 1) / 2;
    if (lane & off) {
      base += h;
      real = real > h ? real - h : 0;
    } else {
      real = real < h ? real : h;
    }
    size = h;
  }
  return real >= 1 ? base : -1;
}

// The lane that warp_reduce_scatter<C> leaves component c on.
__host__ __device__ constexpr int owner_lane(int C, int c) {
  for (int lane = 0; lane < 32; ++lane)
    if (scatter_component(C, lane) == c) return lane;
  return -1;
}

// K sums over the warp on every lane.  From four sums on, a reduce-scatter
// and each sum broadcast from its lane (⌈K/2⌉ + ⌈K/4⌉ + … + K shuffles, not
// the butterfly's 5K): recursive halving pairs the lanes as the butterfly
// does, each adding its own partial first, so every sum has the butterfly's
// bits.
template <typename R, int K>
__device__ __forceinline__ void warp_allsums(R (&v)[K]) {
  if constexpr (K >= 4) {
    const R mine = warp_reduce_scatter<R, K>(v);
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = __shfl_sync(kFull, mine, owner_lane(K, k));
  } else {
    warp_sums<R, K>(v);
  }
}

// Stage clocks (built only with -DYFM_SSD_CLOCKS, as its own library that
// chip_smoke.py alone loads): clock64() stamps between the stages of a step,
// each stage's cycles summed over the steps, written by lane 0 of draw 0.
enum Stage {
  kHead,        // the step's loads and finite flags
  kOls1,        // the 3×3 solve for β̄ on Z(γ_t)
  kScore1,      // the score's first round (λ: the whole score)
  kScore2,      // the curvature transform's adjoint
  kScore3,      // the eighteen MLP parameter sums
  kUpdate,      // the γ step (EWMA or plain)
  kBuildObs,    // Z(γ_obs) and OLS's sums on it
  kTransition,  // γ ← ν + Bγ and Z(γ_next) with its sums
  kHandoff,     // the re-OLS sums and Z_next to the helper warp (in a
                // one-warp launch: the re-OLS, β and the loss in line)
  kStampPair,   // two stamps back to back: what a stamp itself costs
  kMainStages,
  kHelperWait = kMainStages,  // the helper warp waiting for a step's handoff
  kHelperWork,  // its re-OLS, β ← μ + Φβ and the prediction error
  kStages
};

#ifdef YFM_SSD_CLOCKS
struct Clock {
  long long last, acc[kMainStages];
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int s = 0; s < kMainStages; ++s) acc[s] = 0;
    last = clock64();
  }
  __device__ __forceinline__ void stamp(Stage s) {
    const long long c = clock64();
    acc[s] += c - last;
    last = c;
  }
};
#else
struct Clock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void stamp(Stage) {}
};
#endif

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

// The normal equations of OLS on [1 | z₂ | z₃] against one observation:
// Gram entries (g₁₁ = n) and right-hand sides, the same bits on every lane.
template <typename R> struct Gram {
  R g21, g22, g31, g32, g33, b1, b2, b3;
};

// Z(γ)'s columns 2 and 3 on the lane's slots, what the inner sweep needs of
// the forward pass, and OLS's Gram against NY observations.
template <typename R, bool NEURAL, int PL, int NY> struct Build {
  R z2[PL], z3[PL];
  // neural: raw and tanh activations of both nets, slope-transform t, c,
  // curvature-transform r, r2, S and the denominator (or its inverse)
  R raw2[PL], h2[PL][3], raw3[PL], h3[PL][3], t[PL], c, r[PL], r2[PL], sum_sq, d;
  // λ: λ and e^{−λτ}
  R lam, zt[PL];
  Gram<R> gram[NY];
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

// Z(γ) from γ ``g``, and OLS's sums against each ys[q] in the build's own
// reductions: every sum that needs only z₂ and y (Σz₂, Σz₂², Σz₂y, Σy)
// rides in the butterfly of the curvature transform's Σr2², the four that
// need z₃ in one more after it (λ: all in one).  Each sum starts from the
// lane's own partial and takes the butterfly's pairing, so OLS sees the
// bits that summing after the build would give.
template <typename R, bool NEURAL, int PL, int NY>
__device__ __forceinline__ void build(Build<R, NEURAL, PL, NY>& b, const R* g,
                                      const Slots<R, PL>& s, int n, bool transformed,
                                      R x1, R dx, const R (&ys)[NY][PL]) {
  if constexpr (!NEURAL) {
    constexpr int K = 5 + 3 * NY;
    R sum[K];
#pragma unroll
    for (int q = 0; q < K; ++q) sum[q] = R(0);
    b.lam = R(kLamFloor) + dexp(g[0]);
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      R zt = dexp(-b.lam * s.tau[k]);
      R z2 = (R(1) - zt) / (b.lam * s.tau[k]);
      b.zt[k] = zt;
      b.z2[k] = s.on[k] ? z2 : R(0);
      b.z3[k] = s.on[k] ? z2 - zt : R(0);
      sum[0] += b.z2[k];
      sum[1] += b.z3[k];
      sum[2] += b.z2[k] * b.z2[k];
      sum[3] += b.z3[k] * b.z2[k];
      sum[4] += b.z3[k] * b.z3[k];
#pragma unroll
      for (int q = 0; q < NY; ++q) {
        sum[5 + 3 * q] += b.z2[k] * ys[q][k];
        sum[6 + 3 * q] += b.z3[k] * ys[q][k];
        sum[7 + 3 * q] += ys[q][k];
      }
    }
    warp_allsums<R, K>(sum);
#pragma unroll
    for (int q = 0; q < NY; ++q)
      b.gram[q] = {sum[0], sum[2], sum[1], sum[3], sum[4], sum[7 + 3 * q], sum[5 + 3 * q],
                   sum[6 + 3 * q]};
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
  constexpr int KA = 3 + 2 * NY, KB = 3 + NY;
  R sa[KA], sb[KB];
#pragma unroll
  for (int q = 0; q < KA; ++q) sa[q] = R(0);
#pragma unroll
  for (int q = 0; q < KB; ++q) sb[q] = R(0);
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    int i = s.idx[k];
    b.r[k] = transformed ? b.raw3[k] - (slope * s.tau[k] - intercept) : b.raw3[k];
    b.r2[k] = (s.on[k] && i >= 1 && i <= n - 2) ? b.r[k] * b.r[k] : R(0);
    sa[0] += b.r2[k] * b.r2[k];
    sa[1] += b.z2[k];
    sa[2] += b.z2[k] * b.z2[k];
#pragma unroll
    for (int q = 0; q < NY; ++q) {
      sa[3 + 2 * q] += b.z2[k] * ys[q][k];
      sa[4 + 2 * q] += ys[q][k];
    }
  }
  warp_allsums<R, KA>(sa);
  b.sum_sq = sa[0];
  if (transformed) {
    b.d = dsqrt(b.sum_sq) / R(kScale) + R(kEps7);
#pragma unroll
    for (int k = 0; k < PL; ++k) b.z3[k] = b.r2[k] / b.d;
  } else {
    b.d = R(kScale) / dsqrt(b.sum_sq) + R(kEps7);
#pragma unroll
    for (int k = 0; k < PL; ++k) b.z3[k] = b.r2[k] * b.d;
  }
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    sb[0] += b.z3[k];
    sb[1] += b.z3[k] * b.z2[k];
    sb[2] += b.z3[k] * b.z3[k];
#pragma unroll
    for (int q = 0; q < NY; ++q) sb[3 + q] += b.z3[k] * ys[q][k];
  }
  warp_allsums<R, KB>(sb);
#pragma unroll
  for (int q = 0; q < NY; ++q)
    b.gram[q] = {sa[1], sa[2], sb[0], sb[1], sb[2], sa[4 + 2 * q], sa[3 + 2 * q], sb[3 + q]};
  }
}

// Z(γ_obs) taken as the next step's Z(γ_t) under a random walk, with its
// Gram against y_{t+1}.
template <typename R, bool NEURAL, int PL, int NY>
__device__ __forceinline__ void carry(Build<R, NEURAL, PL, 1>& to,
                                      const Build<R, NEURAL, PL, NY>& from) {
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    to.z2[k] = from.z2[k];
    to.z3[k] = from.z3[k];
    to.raw2[k] = from.raw2[k];
    to.raw3[k] = from.raw3[k];
    to.t[k] = from.t[k];
    to.r[k] = from.r[k];
    to.r2[k] = from.r2[k];
    to.zt[k] = from.zt[k];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      to.h2[k][j] = from.h2[k][j];
      to.h3[k][j] = from.h3[k][j];
    }
  }
  to.c = from.c;
  to.sum_sq = from.sum_sq;
  to.d = from.d;
  to.lam = from.lam;
  to.gram[0] = from.gram[NY - 1];
}

// 3×3 Cholesky of the normal equations (l11 l21 l22 l31 l32 l33)
template <typename R>
__device__ __forceinline__ void chol3(R g11, R g21, R g22, R g31, R g32, R g33, R (&l)[6]) {
  l[0] = dsqrt(g11);
  l[1] = g21 / l[0];
  l[3] = g31 / l[0];
  l[2] = dsqrt(g22 - l[1] * l[1]);
  l[4] = (g32 - l[3] * l[1]) / l[2];
  l[5] = dsqrt(g33 - l[3] * l[3] - l[4] * l[4]);
}

// β from the normal equations: the plain factor where all six pivots are
// finite, else the +1e-3 ridge one (ops/linalg.ols_solve).  Every lane
// holds the same sums, so the ridge branch is warp-uniform, and taken only
// when the plain factor fails.
template <typename R>
__device__ __forceinline__ void ols(const Gram<R>& G, int n, R (&beta)[3]) {
  R l[6];
  chol3<R>(R(n), G.g21, G.g22, G.g31, G.g32, G.g33, l);
  bool ok = true;
#pragma unroll
  for (int q = 0; q < 6; ++q) ok = ok && isfinite(l[q]);
  if (!ok)
    chol3<R>(R(n) + R(kRidge), G.g21, G.g22 + R(kRidge), G.g31, G.g32, G.g33 + R(kRidge), l);
  const R l11 = l[0], l21 = l[1], l22 = l[2], l31 = l[3], l32 = l[4], l33 = l[5];
  R y1 = G.b1 / l11;
  R y2 = (G.b2 - l21 * y1) / l22;
  R y3 = (G.b3 - l31 * y1 - l32 * y2) / l33;
  beta[2] = y3 / l33;
  beta[1] = (y2 - l32 * beta[2]) / l22;
  beta[0] = (y1 - l21 * beta[1] - l31 * beta[2]) / l11;
}

// ∇_γ −‖y − Zβ̄‖² with β̄ fixed: the hand-derived reverse sweep through the
// loading build (ops/fused_ssd.py's module docstring has the formulas).
// Neural: returns the lane's component of the score, reduce-scattered (the
// value of component scatter_component(18, lane)); λ: the score on every
// lane.
template <typename R, bool NEURAL, int PL, int NY>
__device__ __forceinline__ R score(const Build<R, NEURAL, PL, NY>& b, const R* g,
                                   const Slots<R, PL>& s, const R (&ys)[PL],
                                   const R (&beta)[3], int n, bool transformed, R x1,
                                   R inv_dx, Clock& ck) {
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
    const R grad = warp_sum<R>(acc) * (b.lam - R(kLamFloor));
    ck.stamp(kScore1);
    return grad;
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
  if (transformed) {
    warp_sums<R, 3>(r1);
  } else {
    r1[2] = warp_sum<R>(r1[2]);
  }
  ck.stamp(kScore1);
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
  ck.stamp(kScore2);
  // round 3: the eighteen MLP parameter sums, both nets at once, each left
  // on one lane
  R grad[18];
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
  const R mine = warp_reduce_scatter<R, 18>(grad);
  ck.stamp(kScore3);
  return mine;
  }
}

// What the chain warp hands the helper warp each step: the re-OLS sums
// (observed steps) and Z(γ_next), maturity-indexed.
template <typename R, int PL> struct Handoff {
  Gram<R> gram;
  R z2[32 * PL], z3[32 * PL];
};

// The maturities a lane holds: slot k is maturity lane + 32k.
template <typename R, int PL>
__device__ __forceinline__ Slots<R, PL> slots_of(int lane, int n, const R* mats) {
  Slots<R, PL> s;
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    s.idx[k] = lane + 32 * k;
    s.on[k] = s.idx[k] < n;
    s.tau[k] = s.on[k] ? mats[s.idx[k]] : R(0);
  }
  return s;
}

// A column as read, its NaN entries as 0, whether its first entry is finite
// (the step is observed) and whether every entry is (else β is poisoned).
template <typename R, int PL>
__device__ __forceinline__ void take(const Slots<R, PL>& s, const R (&col)[PL],
                                     R (&safe)[PL], bool& first, bool& all) {
  bool fin = true;
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    fin = fin && (isfinite(col[k]) || !s.on[k]);
    safe[k] = (s.on[k] && isfinite(col[k])) ? col[k] : R(0);
  }
  first = __shfl_sync(kFull, (int)isfinite(col[0]), 0);
  all = __all_sync(kFull, fin);
}

// β and the loss: what a step does after Z(γ_next) — the re-OLS solve on an
// observed step (NaN-poisoned when the column is partly missing), β ← μ +
// Φβ, and −Σ(y_{t+1} − Z_next β)² over the window.
template <typename R, int PL> struct Tail {
  const R* mu;  // μ then Φ (row-major): the draw's row, read each step
  R beta[3], loss;

  __device__ __forceinline__ Tail(const R* row_mu, const R* delta)
      : mu(row_mu), beta{delta[0], delta[1], delta[2]}, loss(R(0)) {}

  __device__ __forceinline__ void step(const Gram<R>& g, bool obs, bool all_fin,
                                       bool in_window, const R (&z2)[PL], const R (&z3)[PL],
                                       const R (&yn)[PL], const Slots<R, PL>& s, int n) {
    R beta_obs[3] = {beta[0], beta[1], beta[2]};
    if (obs) {
      ols<R>(g, n, beta_obs);
      if (!all_fin) {
#pragma unroll
        for (int m = 0; m < 3; ++m) beta_obs[m] = beta_obs[m] * R(NAN);
      }
    }
    const R* Phi = mu + 3;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      beta[m] = mu[m] + (Phi[3 * m] * beta_obs[0] + Phi[3 * m + 1] * beta_obs[1] +
                         Phi[3 * m + 2] * beta_obs[2]);
    if (in_window) {
      R sq = R(0);
#pragma unroll
      for (int k = 0; k < PL; ++k) {
        if (!s.on[k]) continue;
        R pv = yn[k] - (beta[0] + beta[1] * z2[k] + beta[2] * z3[k]);
        sq += pv * pv;
      }
      loss = loss + -warp_sum<R>(sq);
    }
  }
};

// One draw's pass.  The chain warp runs the γ recursion — OLS β̄, the
// score, the γ step and the loading builds, whose dependent chain sets the
// time at one draw.  SPLIT: a second, helper warp takes the tail (β, the
// re-OLS and the loss) one step behind, fed at the end of each step through
// shared memory and two named barriers, so that the chain warp's issue
// stays on the chain; else the chain warp runs the tail itself (more draws
// resident when the batch fills the card).  Lane i holds maturity i (slot
// k maturity i + 32k).  γ: neural, each of the 18 components lives on the
// lane the score's reduce-scatter leaves it on (its value, EWMA moment, A,
// ν and B in registers), and every lane reads the current γ from the draw's
// row in shared memory; λ, every lane carries the one component.
template <typename R, bool NEURAL, int PL, bool HAS_B, bool SPLIT>
__global__ void __launch_bounds__(kDraws * (SPLIT ? 64 : 32))
ssd_loss_kernel(int flags, int B, int n, int T, int start, int end, R ff, R x1, R dx,
                R inv_dx, const R* __restrict__ draws, const R* __restrict__ data,
                const R* __restrict__ mats, R* __restrict__ out,
                long long* __restrict__ clocks) {
  constexpr int LM = NEURAL ? 18 : 1;
  constexpr int W = 4 * LM + 15;  // [A | B | ν | ω | δ | μ | Φ]
  // Z(γ_obs) is also Z_next under a random walk: its Gram against y_{t+1}
  // is the next step's
  constexpr int NYO = HAS_B ? 1 : 2;
  __shared__ R sp[kDraws][W + LM];  // the draw's row, then γ
  __shared__ Handoff<R, SPLIT ? PL : 1> hand[SPLIT ? kDraws : 1];
  // warps 0..kDraws−1 run the chains, kDraws.. the helpers (SPLIT)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool helper = SPLIT && warp >= kDraws;
  const int pair = helper ? warp - kDraws : warp;
  const int draw = blockIdx.x * kDraws + pair;
  if (draw >= B) return;  // both warps of the draw: only they share barriers
  const int full = 1 + 2 * pair, free = 2 + 2 * pair;  // named barrier ids
  const R* row = draws + (size_t)draw * W;
  const Slots<R, PL> s = slots_of<R, PL>(lane, n, mats);
  Clock ck;

  if constexpr (SPLIT) {
    if (helper) {
      Handoff<R, PL>& h = hand[pair];
      Tail<R, PL> tail(row + 4 * LM + 3, row + 4 * LM);
      R y[PL], ys[PL];
      bool fin0, all_fin;
#pragma unroll
      for (int k = 0; k < PL; ++k) y[k] = s.on[k] ? data[s.idx[k]] : R(0);
      take<R, PL>(s, y, ys, fin0, all_fin);
      long long wait = 0, work = 0;
      for (int t = 0; t < T - 1; ++t) {
        R yn[PL];
#pragma unroll
        for (int k = 0; k < PL; ++k)
          yn[k] = s.on[k] ? data[(size_t)(t + 1) * n + s.idx[k]] : R(0);
        const bool obs = start <= t && t < end && fin0;
#ifdef YFM_SSD_CLOCKS
        const long long c0 = clock64();
#endif
        pair_sync(full);
#ifdef YFM_SSD_CLOCKS
        const long long c1 = clock64();
#endif
        const Gram<R> g = h.gram;
        R z2[PL], z3[PL];
#pragma unroll
        for (int k = 0; k < PL; ++k) {
          z2[k] = h.z2[s.idx[k]];
          z3[k] = h.z3[s.idx[k]];
        }
        if (t < T - 2) pair_arrive(free);
        tail.step(g, obs, all_fin, start <= t && t <= end - 2, z2, z3, yn, s, n);
        take<R, PL>(s, yn, ys, fin0, all_fin);
#ifdef YFM_SSD_CLOCKS
        const long long c2 = clock64();
        wait += c1 - c0;
        work += c2 - c1;
#endif
      }
#ifdef YFM_SSD_CLOCKS
      if (draw == 0 && lane == 0) {
        clocks[kHelperWait] = wait;
        clocks[kHelperWork] = work;
      }
#endif
      if (lane == 0) {
        R l = tail.loss / R(n) / R(end - start);
        out[draw] = isfinite(l) ? l : R(-INFINITY);
      }
      return;
    }
  }

  // ---- the chain warp
  R* p = sp[pair];
  for (int q = lane; q < W; q += 32) p[q] = row[q];
  R* gs = p + W;
  for (int q = lane; q < LM; q += 32) gs[q] = row[3 * LM + q];
  __syncwarp();

  // this lane's γ component (neural: −1 on a padding lane)
  const int comp = NEURAL ? scatter_component(18, lane) : 0;
  const int cq = comp < 0 ? 0 : comp;
  R gam = p[3 * LM + cq], ewma = R(0);
  const R a_m = p[cq], b_m = p[LM + cq], nu_m = p[2 * LM + cq];
  R count = R(0);
  const R one_m_ff = R(1) - ff;
  const R eps = R(sizeof(R) == 4 ? 1.1920928955078125e-07 : 2.220446049250313e-16);
  // 1 − ff^count for 32 observed counts from the next multiple of 32, one a
  // lane: filled when the count reaches it, each read by a shuffle
  R pw = R(0);
  int n_obs = 0;
  Tail<R, PL> tail(p + 4 * LM + 3, p + 4 * LM);  // the one-warp launch's tail

  R y[PL], ys[1][PL];
  bool fin0, all_fin;
#pragma unroll
  for (int k = 0; k < PL; ++k) y[k] = s.on[k] ? data[s.idx[k]] : R(0);
  take<R, PL>(s, y, ys[0], fin0, all_fin);

  const bool transformed = flags & 2, scale_grad = flags & 4;
  Build<R, NEURAL, PL, 1> bd;    // Z(γ_t), its Gram against y_t
  Build<R, NEURAL, PL, NYO> bo;  // Z(γ_obs), against y_t (and y_{t+1})
  const R* gp = NEURAL ? static_cast<const R*>(gs) : &gam;
  build<R, NEURAL, PL, 1>(bd, gp, s, n, transformed, x1, dx, ys);  // Z(γ₀)

  ck.start();
  for (int t = 0; t < T - 1; ++t) {
    // the next column is loaded here and read once the observed part of the
    // step has hidden the load
    R yn[PL], ysn[1][PL];
    bool fin0_next, all_fin_next;
#pragma unroll
    for (int k = 0; k < PL; ++k) yn[k] = s.on[k] ? data[(size_t)(t + 1) * n + s.idx[k]] : R(0);
    const bool obs = start <= t && t < end && fin0;
    ck.stamp(kHead);

    if (obs) {
      R b_ols[3];
      ols<R>(bd.gram[0], n, b_ols);
      ck.stamp(kOls1);
      const R grad = score<R, NEURAL, PL, 1>(bd, gp, s, ys[0], b_ols, n, transformed, x1,
                                             inv_dx, ck);
      if (scale_grad) {
        if ((n_obs & 31) == 0) pw = R(1) - dpow(ff, count + R(lane + 1));
        const R denom = __shfl_sync(kFull, pw, n_obs & 31);
        count = count + R(1);
        if (comp >= 0) {
          ewma = ff * ewma + one_m_ff * grad * grad;
          gam = gam + grad / (dsqrt(ewma / denom) + eps) * a_m;
        }
      } else if (comp >= 0) {
        gam = gam + grad * a_m;
      }
      ++n_obs;
      if constexpr (NEURAL) {
        __syncwarp();
        if (comp >= 0) gs[comp] = gam;
        __syncwarp();
      }
      ck.stamp(kUpdate);
      take<R, PL>(s, yn, ysn[0], fin0_next, all_fin_next);
      // Z(γ_obs) against y_t for the re-OLS, and against y_{t+1} for the
      // next step's OLS when it is also Z_next
      R yy[NYO][PL];
#pragma unroll
      for (int k = 0; k < PL; ++k) {
        yy[0][k] = ys[0][k];
        yy[NYO - 1][k] = HAS_B ? ys[0][k] : ysn[0][k];
      }
      build<R, NEURAL, PL, NYO>(bo, gp, s, n, transformed, x1, dx, yy);
      ck.stamp(kBuildObs);
    } else {
      take<R, PL>(s, yn, ysn[0], fin0_next, all_fin_next);
    }
    // transition: γ ← ν + B⊙γ and Z(γ_next) against y_{t+1}, or the random
    // walk's carry
    if (HAS_B) {
      if (comp >= 0) gam = nu_m + b_m * gam;
      if constexpr (NEURAL) {
        __syncwarp();
        if (comp >= 0) gs[comp] = gam;
        __syncwarp();
      }
      build<R, NEURAL, PL, 1>(bd, gp, s, n, transformed, x1, dx, ysn);
    } else if (obs) {
      carry(bd, bo);
    } else {
      // γ and Z unchanged: only the Gram's right-hand sides move to y_{t+1}
      build<R, NEURAL, PL, 1>(bd, gp, s, n, transformed, x1, dx, ysn);
    }
    ck.stamp(kTransition);
    if constexpr (SPLIT) {
      // hand the helper this step once it has taken the last one
      Handoff<R, PL>& h = hand[pair];
      if (t > 0) pair_sync(free);
      if (obs && lane == 0) h.gram = bo.gram[0];
#pragma unroll
      for (int k = 0; k < PL; ++k) {
        h.z2[s.idx[k]] = bd.z2[k];
        h.z3[s.idx[k]] = bd.z3[k];
      }
      __syncwarp();
      pair_arrive(full);
    } else {
      tail.step(bo.gram[0], obs, all_fin, start <= t && t <= end - 2, bd.z2, bd.z3, yn, s,
                n);
    }
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      y[k] = yn[k];
      ys[0][k] = ysn[0][k];
    }
    fin0 = fin0_next;
    all_fin = all_fin_next;
    ck.stamp(kHandoff);
    ck.stamp(kStampPair);
  }
#ifdef YFM_SSD_CLOCKS
  if (draw == 0 && lane == 0) {
    long long loop = 0;
    for (int q = 0; q < kMainStages; ++q) {
      clocks[q] = ck.acc[q];
      loop += ck.acc[q];
    }
    clocks[kStages] = T - 1;
    clocks[kStages + 1] = n_obs;
    clocks[kStages + 2] = loop;
  }
#endif
  if (!SPLIT && lane == 0) {
    R l = tail.loss / R(n) / R(end - start);
    out[draw] = isfinite(l) ? l : R(-INFINITY);
  }
}

// One launch's arguments, as the C entry point takes them.
struct Args {
  int flags, B, n, T, start, end;
  double ff, x1, dx, inv_dx;
  const void *draws, *data, *mats;
  void* out;
  long long* clocks;  // stage clocks (the clock build), else null
  cudaStream_t stream;
};

template <typename R, bool NEURAL, int PL, bool HAS_B, bool SPLIT>
cudaError_t launch(const Args& a) {
  const int blocks = (a.B + kDraws - 1) / kDraws;
  ssd_loss_kernel<R, NEURAL, PL, HAS_B, SPLIT><<<blocks, kDraws * (SPLIT ? 64 : 32), 0,
                                                 a.stream>>>(
      a.flags, a.B, a.n, a.T, a.start, a.end, R(a.ff), R(a.x1), R(a.dx), R(a.inv_dx),
      static_cast<const R*>(a.draws), static_cast<const R*>(a.data),
      static_cast<const R*>(a.mats), static_cast<R*>(a.out), a.clocks);
  return cudaGetLastError();
}

// The two-warp launch while every draw's pair is resident at once (the card
// holds the whole batch in one wave), the one-warp launch beyond: there the
// helpers would halve the draws each SM runs.
template <typename R, bool NEURAL, int PL, bool HAS_B>
cudaError_t split_or_not(const Args& a) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ssd_loss_kernel<R, NEURAL, PL, HAS_B, true>, kDraws * 64, 0);
  if (err != cudaSuccess) return err;
  if (a.B <= (long long)per_sm * sms * kDraws) return launch<R, NEURAL, PL, HAS_B, true>(a);
  return launch<R, NEURAL, PL, HAS_B, false>(a);
}

template <typename R, bool NEURAL, int PL>
cudaError_t run(const Args& a) {
  return (a.flags & 8) ? split_or_not<R, NEURAL, PL, true>(a)
                        : split_or_not<R, NEURAL, PL, false>(a);
}

template <typename R>
cudaError_t dispatch(int L, const Args& a) {
  const bool neural = a.flags & 1;
  if (neural != (L == 18) || (!neural && L != 1) || a.n < 3 || a.n > 128 || a.T < 2)
    return cudaErrorInvalidValue;
  if (a.n <= 32) return neural ? run<R, true, 1>(a) : run<R, false, 1>(a);
  return neural ? run<R, true, 4>(a) : run<R, false, 4>(a);
}

int entry(int dtype, int L, const Args& a) {
  if (a.B <= 0) return 0;
  if (dtype == 0) return dispatch<float>(L, a);
  if (dtype == 1) return dispatch<double>(L, a);
  return cudaErrorInvalidValue;
}

#ifdef YFM_SSD_CLOCKS
// Cycles a dependent operation of each class takes on one warp: a chain of
// kLatReps operations between two stamps, for the latency-chain bound.
constexpr int kLatReps = 128;
enum LatOp { kAdd, kMul, kDiv, kSqrt, kTanh, kExp, kShfl, kStamp, kLatOps };

template <typename R>
__global__ void latency_kernel(R c, long long* __restrict__ out, R* __restrict__ sink) {
  const int lane = threadIdx.x;
  R x = c + R(lane) * R(1e-3);
  long long cyc[kLatOps];
#define YFM_CHAIN(op, expr)                          \
  {                                                  \
    __syncwarp();                                    \
    const long long t0 = clock64();                  \
    _Pragma("unroll") for (int i = 0; i < kLatReps; ++i) x = (expr); \
    const long long t1 = clock64();                  \
    cyc[op] = t1 - t0;                               \
  }
  YFM_CHAIN(kAdd, x + c)
  YFM_CHAIN(kMul, x * c)
  YFM_CHAIN(kDiv, c / x)
  YFM_CHAIN(kSqrt, dsqrt(x))
  YFM_CHAIN(kTanh, dtanh(x))
  YFM_CHAIN(kExp, dexp(-x))
  YFM_CHAIN(kShfl, __shfl_xor_sync(kFull, x, 1))
#undef YFM_CHAIN
  {
    const long long t0 = clock64();
    const long long t1 = clock64();
    cyc[kStamp] = (t1 - t0) * kLatReps;
  }
  if (lane == 0)
    for (int q = 0; q < kLatOps; ++q) out[q] = cyc[q];
  sink[lane] = x;
}
#endif

}  // namespace

// dtype 0 = float32, 1 = float64; flags: 1 neural, 2 transformed, 4 EWMA
// scale_grad, 8 AR(1) γ dynamics.  draws (B, 4L+15) draw-major, data (T, N),
// mats (N,), out (B,).  Returns the launch's cudaError_t.
extern "C" int yfm_fused_ssd(int dtype, int flags, int L, int B, int n, int T, int start,
                             int end, double ff, double x1, double dx, double inv_dx,
                             const void* draws, const void* data, const void* mats,
                             void* out, void* stream) {
  return entry(dtype, L, {flags, B, n, T, start, end, ff, x1, dx, inv_dx, draws, data, mats,
                          out, nullptr, static_cast<cudaStream_t>(stream)});
}

#ifdef YFM_SSD_CLOCKS
// The same launch with stage clocks: ``clocks`` (kStages + 3,) int64 gets
// draw 0's cycles by stage (the chain warp's, then the helper warp's wait
// and work), the step count, the observed steps and the chain warp's loop.
extern "C" int yfm_fused_ssd_clocks(int dtype, int flags, int L, int B, int n, int T,
                                    int start, int end, double ff, double x1, double dx,
                                    double inv_dx, const void* draws, const void* data,
                                    const void* mats, void* out, void* clocks,
                                    void* stream) {
  return entry(dtype, L, {flags, B, n, T, start, end, ff, x1, dx, inv_dx, draws, data, mats,
                          out, static_cast<long long*>(clocks),
                          static_cast<cudaStream_t>(stream)});
}

// One warp's cycles for kLatReps dependent operations of each class into
// ``out`` (kLatOps,) int64, in the working type: add, mul, div, sqrt, tanh,
// exp, shuffle, and one stamp (× kLatReps).  ``sink`` (32,) keeps the
// chains alive.
extern "C" int yfm_ssd_latencies(int dtype, void* out, void* sink, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    latency_kernel<float><<<1, 32, 0, st>>>(0.75f, static_cast<long long*>(out),
                                            static_cast<float*>(sink));
  else if (dtype == 1)
    latency_kernel<double><<<1, 32, 0, st>>>(0.75, static_cast<long long*>(out),
                                             static_cast<double*>(sink));
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
#endif
