// Fused LandTrendr segmentation kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `jax_segment_pixels_pallas`
// (land_trendr_tpu/ops/segment_pallas.py:1027; kernel body
// `_make_fused_kernel`, :869, which runs `_run_stages`, :471, then
// `_fused_tail`, :666).  It computes the same whole pipeline per pixel —
// despike, max-deviation candidate search, angle cull, the anchored model
// family with recovery clamps, F-test scoring, selection and assembly of
// the 13 SegOutputs fields — and its plain PyTorch version is
// land_trendr_tpu_torch/ops/segment.py, which follows this file
// expression for expression (every sum in year order, ties to the
// smallest position).
//
// Design.  One thread per pixel, blocks of CUDA_BLOCK threads, the ragged
// edge masked.  The year axis t is loaded once per block into shared
// memory.  Each thread compacts its pixel's valid years into per-thread
// arrays of compile-time length MAX_NY (positions 0..n-1), so every stage
// is a short scalar loop over the valid years.  Vertex sets (the candidate
// set and each model-family member) are one 64-bit word each; the family
// keeps only each member's word and SSE, and the tail refits the chosen
// member with the same code (a deterministic refit gives the same bits).
// Inputs arrive year-major (NY, PX) and outputs leave year-major
// (rows, PX), so neighbouring threads touch neighbouring addresses.
//
// What bounds it on this card.  A pixel reads NY values + NY mask bytes
// and writes 2*NY + 4*NV + 3*NM + 3 words and one byte: at NY = 40,
// NV = 7, NM = 6 about 0.7 KB of device-memory traffic (f32), ~0.056 ms
// for 262,144 px at 3.35 TB/s.  Its arithmetic is ~1.5 * 10^4 FP32
// operations per pixel (seven anchored fits, ~10 candidate-search OLS
// passes, despike trips, ~100 atan, the Lentz scorer), ~0.06 ms at the
// FP32 peak: the two bounds sit close together.  What holds the kernel
// back in practice is neither: each thread's work is a long serial chain
// of dependent operations whose trip counts follow its own pixel's data,
// so warps diverge.  The design answers that by keeping every
// intermediate on chip (nothing but the inputs and the 13 outputs touch
// device memory) and by doing only the work a pixel's own data needs
// (early exits in despike, candidate search and the float64 continued
// fraction; no work at all for pixels below min_observations).  The
// per-thread arrays may spill to local memory (L1-cached); registers and
// spills are reported by `-Xptxas -v`.
//
// A second kernel, `family_stats_kernel`, replaces the TPU kernel
// `family_stats_pallas` (land_trendr_tpu/ops/segment_pallas.py:938; body
// `_make_family_kernel`, :645, which runs `_run_stages`, :471): stages
// 1-4a unfused — the despiked series (0 at invalid years), each model-
// family member's vertex set on the year axis and the SSE of its fit.  Its
// plain version is `torch_family_stats` in ops/segment.py; it shares every
// device function with the fused kernel.  It differs from the fused
// kernel's first half in one respect: it runs the family for EVERY pixel
// (none, one or two valid years, below min_observations, a flat series),
// as `_run_stages` does, where the fused kernel skips pixels the tail will
// call flat.  What bounds it: a pixel reads NY values + NY mask bytes and
// writes NY words, NM*NY vertex-set bytes and NM words — at NY = 40,
// NM = 6 0.62 KB (f32), ~0.049 ms for 262,144 px at 3.35 TB/s — against
// ~1.2 * 10^4 FP32 operations per pixel (no scoring), about the same time
// at the FP32 peak.  The design keeps the fused kernel's answer for the
// arithmetic (one thread per pixel, compacted per-thread series, vertex
// sets as 64-bit words) and writes every output year-major, one row per
// (member, year), so a warp's stores to a row are one contiguous run of
// 32 bytes (vertex sets) or 128 bytes (words) instead of one store every
// NM*NY bytes per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
// --fmad=false keeps every multiply and add rounded on its own, step for
// step with the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CUDA_BLOCK = 128;
constexpr int MAX_NY = 64;   // years: one 64-bit word per vertex set
constexpr int MAX_NC = 16;   // candidate capacity (max_segments + 1 + overshoot)
constexpr int MAX_NM = MAX_NC - 1;

constexpr double CF_EPS = 1e-15;
constexpr int CF_MAXIT = 300;
constexpr double CF_TINY = 1e-300;
constexpr double EPS_RATE = 1e-12;
constexpr double LOGP_PERFECT = -1e30;
constexpr double HALF_LOG_2PI = 0.9189385332046727;

struct Params {
  int nm;         // max_segments
  int nv;         // max_segments + 1
  int nc;         // max_segments + 1 + vertex_count_overshoot
  int overshoot;  // vertex_count_overshoot
  double spike;
  double rt;
  int prevent;
  double pval;
  double bmp;
  int min_obs;
  int lentz_iters;
};

template <typename T>
struct Outs {
  T* despiked;         // (NY, ld)
  T* fitted;           // (NY, ld)
  int32_t* n_vertices; // (1, ld)
  int32_t* vidx;       // (NV, ld)
  T* vyear;            // (NV, ld)
  T* vsrc;             // (NV, ld)
  T* vfit;             // (NV, ld)
  T* smag;             // (NM, ld)
  T* sdur;             // (NM, ld)
  T* srate;            // (NM, ld)
  T* rmse;             // (1, ld)
  T* pof;              // (1, ld)
  uint8_t* mv;         // (1, ld)
  long long ld;
};

// ---- elementary functions, one overload per type --------------------------
__device__ __forceinline__ float f_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double f_abs(double x) { return fabs(x); }
__device__ __forceinline__ float f_atan(float x) { return atanf(x); }
__device__ __forceinline__ double f_atan(double x) { return atan(x); }
__device__ __forceinline__ float f_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double f_sqrt(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T t_max(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T t_min(T a, T b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ T ulp_of_eps();
template <>
__device__ __forceinline__ float ulp_of_eps<float>() { return 1.4210855e-14f; }  // 2^-46
template <>
__device__ __forceinline__ double ulp_of_eps<double>() { return 4.930380657631324e-32; }  // 2^-104

// Floating-point operation tally of one thread, for the roofline bound:
// CountOps adds the arithmetic each loop performs on this pixel's data
// (an add, multiply, divide, compare, min/max, abs or elementary function
// each count one); NoOps compiles to nothing on the production path.
struct NoOps {
  __device__ __forceinline__ void add(long long) {}
};
struct CountOps {
  long long n = 0;
  __device__ __forceinline__ void add(long long k) { n += k; }
};
template <class O>
struct CountOf {
  __device__ static long long get(const O&) { return 0; }
};
template <>
struct CountOf<CountOps> {
  __device__ static long long get(const CountOps& o) { return o.n; }
};

// Positions of the set bits of `vm`, ascending; returns the count.
__device__ __forceinline__ int bit_positions(uint64_t vm, int* vp) {
  int k = 0;
  while (vm) {
    int b = __ffsll((long long)vm) - 1;
    vp[k++] = b;
    vm &= vm - 1;
  }
  return k;
}

// Per-thread view of one pixel's compacted series.
template <typename T>
struct Series {
  const T* ts;           // shared year axis (uncompacted)
  uint8_t idx[MAX_NY];   // compacted position -> year index
  T y[MAX_NY];           // series at valid years (despiked in place)
  int n;                 // valid years
  __device__ __forceinline__ T t(int i) const { return ts[idx[i]]; }
};

template <typename T>
__device__ __forceinline__ T clamp_slope(T slope, T duration, T y_range, const Params& p) {
  T limit = -(T)p.rt * y_range;
  T clamped = t_max(slope, limit);
  if (p.prevent) clamped = duration <= (T)1 ? (T)0 : clamped;
  bool active = (slope < (T)0) && (y_range > (T)0);
  return active ? clamped : slope;
}

// OLS over compacted positions [a, b]: intercept, slope, tm, ym.
template <typename T, class O>
__device__ void ols(const Series<T>& s, int a, int b, T& c0, T& c1, T& tm, T& ym, O& ops) {
  ops.add(9LL * (b - a + 1) + 7);
  T n = 0, st = 0, sy = 0;
  for (int i = a; i <= b; ++i) {
    n = n + (T)1;
    st = st + s.t(i);
    sy = sy + s.y[i];
  }
  T n_safe = n < (T)1 ? (T)1 : n;
  tm = st / n_safe;
  ym = sy / n_safe;
  T stt = 0, sty = 0;
  for (int i = a; i <= b; ++i) {
    T d = s.t(i) - tm;
    stt = stt + d * d;
    sty = sty + d * (s.y[i] - ym);
  }
  bool ok = (n >= (T)2) && (stt > (T)0);
  c1 = ok ? sty / stt : (T)0;
  c0 = ym - c1 * tm;
}

// Stage 1: iteratively damp the largest interior spike (oracle despike).
template <typename T, class O>
__device__ void despike(Series<T>& s, const Params& p, O& ops) {
  const int n = s.n;
  const T thr = (T)p.spike;
  for (int it = 0; it < n; ++it) {
    ops.add(15LL * (n > 2 ? n - 2 : 0) + 4);
    T best = (T)-1, best_itp = 0;
    int bi = -1;
    for (int i = 1; i <= n - 2; ++i) {
      T tp = s.t(i - 1), tq = s.t(i + 1), ti = s.t(i);
      T yp = s.y[i - 1], yq = s.y[i + 1];
      T itp = yp + (yq - yp) * (ti - tp) / (tq - tp);
      T dev = f_abs(s.y[i] - itp);
      T crossing = f_abs(yq - yp);
      T prop = dev > (T)0 ? t_max((T)0, (T)1 - crossing / dev) : (T)0;
      if (prop > best) {
        best = prop;
        bi = i;
        best_itp = itp;
      }
    }
    if (!(best > thr)) break;
    s.y[bi] = s.y[bi] + (best_itp - s.y[bi]) * best;
  }
}

// Stage 2: grow the vertex word by max-deviation insertion.
template <typename T, class O>
__device__ uint64_t find_candidates(const Series<T>& s, uint64_t vm, const Params& p, O& ops) {
  for (int trip = 0; trip < p.nc - 2; ++trip) {
    T best = (T)-1;
    int bi = -1;
    int vp[MAX_NC];
    int k = bit_positions(vm, vp);
    for (int j = 0; j + 1 < k; ++j) {
      int a = vp[j], b = vp[j + 1];
      if (b - a < 2) continue;
      T c0, c1, tm, ym;
      ols(s, a, b, c0, c1, tm, ym, ops);
      ops.add(5LL * (b - a - 1));
      for (int i = a + 1; i < b; ++i) {
        T dev = f_abs(s.y[i] - (c0 + c1 * s.t(i)));
        if (dev > best) {
          best = dev;
          bi = i;
        }
      }
    }
    if (bi < 0) break;  // no interior year left anywhere: later trips are no-ops
    vm |= 1ull << bi;
  }
  return vm;
}

// Drop the min-angle interior vertex while the count exceeds keep_above.
template <typename T, class O>
__device__ uint64_t remove_weakest(const Series<T>& s, uint64_t vm, int keep_above,
                                   T t_lo, T t_rng, T y_lo, T y_rng, O& ops) {
  int vp[MAX_NC];
  int k = bit_positions(vm, vp);
  if (k <= keep_above) return vm;
  ops.add(23LL * (k - 2));
  T best = 0;
  int jmin = -1;
  for (int j = 1; j <= k - 2; ++j) {
    T xs0 = (s.t(vp[j - 1]) - t_lo) / t_rng, ys0 = (s.y[vp[j - 1]] - y_lo) / y_rng;
    T xs1 = (s.t(vp[j]) - t_lo) / t_rng, ys1 = (s.y[vp[j]] - y_lo) / y_rng;
    T xs2 = (s.t(vp[j + 1]) - t_lo) / t_rng, ys2 = (s.y[vp[j + 1]] - y_lo) / y_rng;
    T s1 = (ys1 - ys0) / (xs1 - xs0);
    T s2 = (ys2 - ys1) / (xs2 - xs1);
    T ang = f_abs(f_atan(s2) - f_atan(s1));
    if (jmin < 0 || ang < best) {
      best = ang;
      jmin = j;
    }
  }
  return vm & ~(1ull << vp[jmin]);
}

// Anchored fit + point-to-point fallback for one vertex word.  Returns the
// SSE over the vertex span; with `vf` non-null also the fitted value at
// each vertex (the chosen model's refit).
template <typename T, class O>
__device__ T fit_model(const Series<T>& s, uint64_t vm, T y_range, const Params& p, T* vf,
                       O& ops) {
  int vp[MAX_NC];
  const int k = bit_positions(vm, vp);
  // regression: 6 per year per pass (two passes after segment 0's OLS);
  // p2p: 6 per year; ~24 per vertex for slopes, clamps, rates and anchors
  ops.add(12LL * (vp[k - 1] - vp[1]) + 6LL * (vp[1] - vp[0] + 1) +
          6LL * (vp[k - 1] - vp[0] + 1) + 24LL * k + 4);
  // --- segment 0: OLS over closed [v0, v1] ---
  T c0, c1, tm, ym;
  ols(s, vp[0], vp[1], c0, c1, tm, ym, ops);
  T c1c = clamp_slope(c1, s.t(vp[1]) - s.t(vp[0]), y_range, p);
  c0 = ym - c1c * tm;
  T sse_reg = 0;
  for (int i = vp[0]; i <= vp[1]; ++i) {
    T r = s.y[i] - (c0 + c1c * s.t(i));
    sse_reg = sse_reg + r * r;
  }
  T vreg[MAX_NC];
  vreg[0] = c0 + c1c * s.t(vp[0]);
  T anchor_t = s.t(vp[1]);
  T anchor_y = c0 + c1c * anchor_t;
  vreg[1] = anchor_y;
  // --- segments 1..: slope-only regression through the anchor ---
  for (int g = 1; g + 1 < k; ++g) {
    const int a = vp[g], b = vp[g + 1];
    T denom = 0, num = 0;
    for (int i = a + 1; i <= b; ++i) {
      T dt = s.t(i) - anchor_t;
      denom = denom + dt * dt;
      num = num + dt * (s.y[i] - anchor_y);
    }
    T slope = denom > (T)0 ? num / denom : (T)0;
    T tb = s.t(b);
    slope = clamp_slope(slope, tb - anchor_t, y_range, p);
    for (int i = a + 1; i <= b; ++i) {
      T r = s.y[i] - (anchor_y + slope * (s.t(i) - anchor_t));
      sse_reg = sse_reg + r * r;
    }
    T new_anchor_y = anchor_y + slope * (tb - anchor_t);
    anchor_t = tb;
    anchor_y = new_anchor_y;
    vreg[g + 1] = anchor_y;
  }
  // --- point-to-point fallback ---
  bool p2p_ok = true;
  T rate[MAX_NC];
  const T rt = (T)p.rt, eps = (T)EPS_RATE;
  for (int g = 0; g + 1 < k; ++g) {
    T dur = s.t(vp[g + 1]) - s.t(vp[g]);
    T dy = s.y[vp[g + 1]] - s.y[vp[g]];
    bool pos = dur > (T)0;
    bool viol = (dy < (T)0) && (y_range > (T)0) && pos;
    bool fast = (-dy) / (pos ? dur : (T)1) > rt * y_range + eps;
    if (p.prevent) fast = fast || (dur <= (T)1);
    if (viol && fast) p2p_ok = false;
    rate[g] = pos ? dy / dur : (T)0;
  }
  T sse_p2p = 0;
  for (int g = 0; g + 1 < k; ++g) {
    const int a = vp[g];
    const int end = (g + 2 == k) ? vp[g + 1] : vp[g + 1] - 1;
    const T ya = s.y[a], ta = s.t(a);
    for (int i = a; i <= end; ++i) {
      T r = s.y[i] - (ya + rate[g] * (s.t(i) - ta));
      sse_p2p = sse_p2p + r * r;
    }
  }
  const bool use_p2p = p2p_ok && (sse_p2p < sse_reg);
  if (vf != nullptr) {
    for (int j = 0; j < k; ++j) {
      if (use_p2p) {
        const int g = j + 1 < k ? j : k - 2;  // the last vertex ends the last segment
        vf[j] = s.y[vp[g]] + rate[g] * (s.t(vp[j]) - s.t(vp[g]));
      } else {
        vf[j] = vreg[j];
      }
    }
  }
  return use_p2p ? sse_p2p : sse_reg;
}

// ---- float32 scoring: the JAX package's fixed-trip Lentz + log-gamma -------
__device__ float lgamma_fixed(float x) {
  float prod = x;
  for (int j = 1; j < 8; ++j) prod = prod * (x + (float)j);
  float z = x + 8.0f;
  float zi = 1.0f / z;
  float zi2 = zi * zi;
  float series = zi * ((float)(1.0 / 12.0) + zi2 * ((float)(-1.0 / 360.0) + zi2 * (float)(1.0 / 1260.0)));
  float lg = (z - 0.5f) * logf(z) - z + (float)HALF_LOG_2PI + series;
  return lg - logf(prod);
}

__device__ __forceinline__ float guard32(float z) {
  const float tiny = (float)1e-30;
  return fabsf(z) < tiny ? tiny : z;
}

__device__ void betainc_p_logp_lentz(float a, float b, float x, int iters, float& p, float& lp) {
  const float tiny = (float)1e-30;
  bool swap = x >= (a + 1.0f) / (a + b + 2.0f);
  float aa = swap ? b : a, bb = swap ? a : b, xx = swap ? 1.0f - x : x;
  float qab = aa + bb, qap = aa + 1.0f, qam = aa - 1.0f;
  float c = 1.0f;
  float d = 1.0f / guard32(1.0f - qab * xx / qap);
  float h = d;
  for (int m = 1; m <= iters; ++m) {
    float mt = (float)m, m2 = (float)(2.0 * m);
    float num = mt * (bb - mt) * xx / ((qam + m2) * (aa + m2));
    d = 1.0f / guard32(1.0f + num * d);
    c = guard32(1.0f + num / c);
    h = h * d * c;
    num = -(aa + mt) * (qab + mt) * xx / ((aa + m2) * (qap + m2));
    d = 1.0f / guard32(1.0f + num * d);
    c = guard32(1.0f + num / c);
    h = h * d * c;
  }
  float log_front = aa * logf(t_max(xx, tiny)) + bb * log1pf(-xx) + lgamma_fixed(qab) -
                    lgamma_fixed(aa) - lgamma_fixed(bb) - logf(aa);
  float p_small = expf(log_front) * h;
  float lp_small = log_front + logf(t_max(h, tiny));
  p = swap ? 1.0f - p_small : p_small;
  lp = swap ? log1pf(-t_min(p_small, (float)(1.0 - 1e-7))) : lp_small;
}

// ---- float64 scoring: regularised incomplete beta to convergence -----------
__device__ __forceinline__ double guard64(double z) {
  return fabs(z) < CF_TINY ? CF_TINY : z;
}

__device__ double rising(double v, double v0) {
  double pr = 1.0;
  const double k = v - v0;
  for (int j = 0; (double)j < k; ++j) pr = pr * (v0 + j);
  return pr;
}

// Gamma(a+b) / (Gamma(a) Gamma(b)): exact products for half-integers.
__device__ double gamma_ratio(double a, double b) {
  double z = a + b;
  bool half = (2.0 * a == floor(2.0 * a)) && (2.0 * b == floor(2.0 * b)) && (z <= 170.0);
  if (!half) return exp(lgamma(z) - lgamma(a) - lgamma(b));
  bool ia = a == floor(a), ib = b == floor(b), iz = z == floor(z);
  double za0 = ia ? 1.0 : 0.5, zb0 = ib ? 1.0 : 0.5, zz0 = iz ? 1.0 : 0.5;
  double r = rising(z, zz0) / (rising(a, za0) * rising(b, zb0));
  if (!ia && !ib) r = r / 3.141592653589793;
  return r;
}

__device__ double betainc64(double a, double b, double x) {
  bool swap = x > (a + 1.0) / (a + b + 2.0);
  double aa = swap ? b : a, bb = swap ? a : b;
  double xx = swap ? 1.0 - x : x, xc = swap ? x : 1.0 - x;
  double qab = aa + bb, qap = aa + 1.0, qam = aa - 1.0;
  double c = 1.0;
  double d = 1.0 / guard64(1.0 - qab * xx / qap);
  double h = d;
  for (int m = 1; m <= CF_MAXIT; ++m) {
    double md = (double)m, m2 = 2.0 * m;
    double num = md * (bb - md) * xx / ((qam + m2) * (aa + m2));
    double d1 = 1.0 / guard64(1.0 + num * d);
    double c1 = guard64(1.0 + num / c);
    double h1 = h * d1 * c1;
    num = -(aa + md) * (qab + md) * xx / ((aa + m2) * (qap + m2));
    double d2 = 1.0 / guard64(1.0 + num * d1);
    double c2 = guard64(1.0 + num / c1);
    double delta = d2 * c2;
    d = d2;
    c = c2;
    h = h1 * delta;
    if (fabs(delta - 1.0) < CF_EPS) break;
  }
  double front = pow(xx, aa) * pow(xc, bb) * gamma_ratio(aa, bb) / aa;
  double r = front * h;
  return swap ? 1.0 - r : r;
}

// (p, selection score) of one family member.  float32: score = log p;
// float64: score = p.
template <class O>
__device__ void f_test(float ss0, float sse, float n, float m, const Params& p, float& pv,
                       float& score, O& ops) {
  ops.add(16);
  float df1 = 2.0f * m - 1.0f, df2 = n - 2.0f * m;
  bool invalid = (df2 < 1.0f) || (ss0 <= 0.0f) || (sse >= ss0);
  bool perfect = (sse <= 0.0f) && !invalid;
  if (invalid) {
    pv = 1.0f;
    score = 0.0f;
    return;
  }
  if (perfect) {
    pv = 0.0f;
    score = (float)LOGP_PERFECT;
    return;
  }
  float df1s = t_max(df1, 1.0f), df2s = t_max(df2, 1.0f);
  float f = ((ss0 - sse) / df1s) / (sse / df2s);
  f = t_max(f, 0.0f);
  float x = df2s / (df2s + df1s * f);
  betainc_p_logp_lentz(df2s / 2.0f, df1s / 2.0f, x, p.lentz_iters, pv, score);
  // Lentz, per trip: 2 x-terms (7 + 8), 4 guarded reciprocal/ratio updates
  // (5 + 4 each half), 2 h products each half, m2 -> 38; set-up ~16;
  // front: 3 fixed log-gammas (30 each: 14 in the rising product, 16 in
  // the Stirling tail) + ~20
  ops.add(38LL * p.lentz_iters + 126);
}

template <class O>
__device__ void f_test(double ss0, double sse, double n, double m, const Params& p,
                       double& pv, double& score, O& ops) {
  ops.add(16);
  double df1 = 2.0 * m - 1.0, df2 = n - 2.0 * m;
  bool invalid = (df2 < 1.0) || (ss0 <= 0.0) || (sse >= ss0);
  bool perfect = (sse <= 0.0) && !invalid;
  if (invalid) {
    pv = score = 1.0;
    return;
  }
  if (perfect) {
    pv = score = 0.0;
    return;
  }
  double df1s = t_max(df1, 1.0), df2s = t_max(df2, 1.0);
  double f = ((ss0 - sse) / df1s) / (sse / df2s);
  f = t_max(f, 0.0);
  double x = df2s / (df2s + df1s * f);
  pv = score = betainc64(df2s / 2.0, df1s / 2.0, x);
}

template <typename T>
__device__ __forceinline__ T select_thresh(T best, const Params& p);
template <>
__device__ __forceinline__ float select_thresh<float>(float best, const Params& p) {
  return best - logf((float)p.bmp);
}
template <>
__device__ __forceinline__ double select_thresh<double>(double best, const Params& p) {
  return best / p.bmp;
}

template <typename T, class O>
__global__ void __launch_bounds__(CUDA_BLOCK)
segment_fused_kernel(const T* __restrict__ years, const T* __restrict__ values,
                     const uint8_t* __restrict__ mask, long long px, long long in_ld, int ny,
                     Outs<T> o, Params p, long long* __restrict__ op_count) {
  __shared__ T ts[MAX_NY];
  if (threadIdx.x < ny) ts[threadIdx.x] = years[threadIdx.x];
  __syncthreads();
  const long long pix = (long long)blockIdx.x * CUDA_BLOCK + threadIdx.x;
  if (pix >= px) return;
  const long long ld = o.ld;

  O ops;
  Series<T> s;
  s.ts = ts;
  int n = 0;
  for (int j = 0; j < ny; ++j) {
    if (mask[j * in_ld + pix]) {
      s.idx[n] = (uint8_t)j;
      s.y[n] = values[j * in_ld + pix];
      ++n;
    }
  }
  s.n = n;
  const bool enough = n >= p.min_obs;
  const T n_f = (T)n;
  const T n_safe = n_f < (T)1 ? (T)1 : n_f;

  bool mv = false;
  T y_range = 0;
  if (enough) {
    despike(s, p, ops);
    ops.add(2LL * n + 2);
    T y_lo = s.y[0], y_hi = s.y[0];
    for (int i = 1; i < n; ++i) {
      y_lo = t_min(y_lo, s.y[i]);
      y_hi = t_max(y_hi, s.y[i]);
    }
    y_range = t_max(y_hi - y_lo, (T)0);
    if (y_range > (T)0) {
      const T t_lo = s.t(0), t_hi = s.t(n - 1);
      const T t_rng = t_hi > t_lo ? t_hi - t_lo : (T)1;
      const T y_rng = y_hi > y_lo ? y_hi - y_lo : (T)1;
      // Stage 2 — candidates + angle cull
      uint64_t vm = (1ull << 0) | (1ull << (n - 1));
      ops.add(4);
      vm = find_candidates(s, vm, p, ops);
      for (int r = 0; r < p.overshoot; ++r)
        vm = remove_weakest(s, vm, p.nv, t_lo, t_rng, y_lo, y_rng, ops);
      // Stage 4 — model family: vertex word + SSE per member
      uint64_t fam_vm[MAX_NM];
      T fam_sse[MAX_NM];
      for (int m = 0; m < p.nm; ++m) {
        fam_vm[m] = vm;
        fam_sse[m] = fit_model(s, vm, y_range, p, (T*)nullptr, ops);
        if (m + 1 < p.nm) vm = remove_weakest(s, vm, 2, t_lo, t_rng, y_lo, y_rng, ops);
      }
      // scoring + selection
      ops.add(4LL * n + 1 + 2LL * p.nm);
      T sum_y = 0;
      for (int i = 0; i < n; ++i) sum_y = sum_y + s.y[i];
      const T mean0 = sum_y / n_safe;
      T ss0 = 0;
      for (int i = 0; i < n; ++i) {
        T d = s.y[i] - mean0;
        ss0 = ss0 + d * d;
      }
      T fam_p[MAX_NM], fam_score[MAX_NM];
      T best = 0;
      for (int m = 0; m < p.nm; ++m) {
        T ms = (T)(__popcll((long long)fam_vm[m]) - 1);
        f_test(ss0, fam_sse[m], n_f, ms, p, fam_p[m], fam_score[m], ops);
        best = m == 0 ? fam_score[0] : t_min(best, fam_score[m]);
      }
      const T thresh = select_thresh<T>(best, p);
      int chosen = p.nm - 1;
      for (int m = 0; m < p.nm; ++m) {
        if (fam_score[m] <= thresh) {
          chosen = m;
          break;
        }
      }
      const T p_c = fam_p[chosen];
      mv = p_c <= (T)p.pval;
      if (mv) {
        // refit the chosen member: its vertex fits and SSE.  The refit
        // trades arithmetic for registers; the function needs none of it
        // (the family loop computed the same values), so the tally for the
        // bound leaves it out.
        T vf[MAX_NC];
        const uint64_t vmc = fam_vm[chosen];
        NoOps refit_ops;
        const T sse_c = fit_model(s, vmc, y_range, p, vf, refit_ops);
        ops.add(10LL * ny + 4LL * p.nm + 2);
        int vp[MAX_NC];
        const int k = bit_positions(vmc, vp);
        for (int j = 0; j < p.nv; ++j) {
          const bool live = j < k;
          o.vidx[j * ld + pix] = live ? (int32_t)s.idx[vp[j]] : -1;
          o.vyear[j * ld + pix] = live ? s.t(vp[j]) : (T)0;
          o.vsrc[j * ld + pix] = live ? s.y[vp[j]] : (T)0;
          o.vfit[j * ld + pix] = live ? vf[j] : (T)0;
        }
        for (int j = 0; j < p.nm; ++j) {
          T mag = 0, dur = 0, rate = 0;
          if (j < k - 1) {
            mag = vf[j + 1] - vf[j];
            dur = s.t(vp[j + 1]) - s.t(vp[j]);
            rate = dur > (T)0 ? mag / dur : (T)0;
          }
          o.smag[j * ld + pix] = mag;
          o.sdur[j * ld + pix] = dur;
          o.srate[j * ld + pix] = rate;
        }
        // fitted trajectory over every year: np.interp through the
        // vertices, dead slots repeating (t_hi, last fit)
        const T eps_g = ulp_of_eps<T>();
        const T x0 = s.t(vp[0]), f0 = vf[0];
        const T xlast = k == p.nv ? s.t(vp[k - 1]) : t_hi;
        const T flast = vf[k - 1];
        int ci = 0;  // vertex slots with xp <= year, walked forward
        for (int j = 0; j < ny; ++j) {
          const T tj = ts[j];
          while (ci < p.nv && (ci < k ? s.t(vp[ci]) : t_hi) <= tj) ++ci;
          const int i = ci < 1 ? 1 : (ci > p.nv - 1 ? p.nv - 1 : ci);
          const T xp_i = i < k ? s.t(vp[i]) : t_hi;
          const T xp_im1 = i - 1 < k ? s.t(vp[i - 1]) : t_hi;
          const T fp_i = i < k ? vf[i] : flast;
          const T fp_im1 = i - 1 < k ? vf[i - 1] : flast;
          const T df = fp_i - fp_im1;
          const T dx = xp_i - xp_im1;
          const T delta = tj - xp_im1;
          T f = f_abs(dx) <= eps_g ? fp_im1 : fp_im1 + (delta / dx) * df;
          if (tj < x0) f = f0;
          if (tj > xlast) f = flast;
          o.fitted[j * ld + pix] = f;
        }
        // despiked output: despiked series at valid years, raw elsewhere
        int c = 0;
        for (int j = 0; j < ny; ++j) {
          T v;
          if (c < n && s.idx[c] == j) {
            v = s.y[c];
            ++c;
          } else {
            v = values[j * in_ld + pix];
          }
          o.despiked[j * ld + pix] = v;
        }
        o.rmse[pix] = f_sqrt(sse_c / n_safe);
        o.pof[pix] = p_c;
        o.n_vertices[pix] = k;
        o.mv[pix] = 1;
        if (op_count != nullptr) op_count[pix] = CountOf<O>::get(ops);
        return;
      }
    }
  }
  // flat no-fit model: the mean of the (despiked when enough) valid series
  T sum_y = 0;
  for (int i = 0; i < n; ++i) sum_y = sum_y + s.y[i];
  const bool has_any = n > 0;
  const T mean = has_any ? sum_y / n_safe : (T)0;
  T ssr = 0;
  for (int i = 0; i < n; ++i) {
    T r = s.y[i] - mean;
    ssr = ssr + r * r;
  }
  for (int j = 0; j < p.nv; ++j) {
    o.vidx[j * ld + pix] = -1;
    o.vyear[j * ld + pix] = 0;
    o.vsrc[j * ld + pix] = 0;
    o.vfit[j * ld + pix] = 0;
  }
  for (int j = 0; j < p.nm; ++j) {
    o.smag[j * ld + pix] = 0;
    o.sdur[j * ld + pix] = 0;
    o.srate[j * ld + pix] = 0;
  }
  int c = 0;
  for (int j = 0; j < ny; ++j) {
    T v = mean;
    if (c < n && s.idx[c] == j) {
      v = s.y[c];
      ++c;
    }
    o.fitted[j * ld + pix] = mean;
    o.despiked[j * ld + pix] = v;
  }
  o.rmse[pix] = has_any ? f_sqrt(ssr / n_safe) : (T)0;
  o.pof[pix] = 1;
  o.n_vertices[pix] = 0;
  o.mv[pix] = 0;
  ops.add(5LL * n + 2);
  if (op_count != nullptr) op_count[pix] = CountOf<O>::get(ops);
}

template <typename T>
struct FamilyOuts {
  T* despiked;       // (NY, ld)
  uint8_t* vmasks;   // (NM * NY, ld): row m * NY + j is member m's year j
  T* sses;           // (NM, ld)
  long long ld;
};

// Stages 1-4a for every pixel: despiked series, family vertex sets, SSEs.
template <typename T, class O>
__global__ void __launch_bounds__(CUDA_BLOCK)
family_stats_kernel(const T* __restrict__ years, const T* __restrict__ values,
                    const uint8_t* __restrict__ mask, long long px, long long in_ld, int ny,
                    FamilyOuts<T> o, Params p, long long* __restrict__ op_count) {
  __shared__ T ts[MAX_NY];
  if (threadIdx.x < ny) ts[threadIdx.x] = years[threadIdx.x];
  __syncthreads();
  const long long pix = (long long)blockIdx.x * CUDA_BLOCK + threadIdx.x;
  if (pix >= px) return;
  const long long ld = o.ld;

  O ops;
  Series<T> s;
  s.ts = ts;
  int n = 0;
  for (int j = 0; j < ny; ++j) {
    if (mask[j * in_ld + pix]) {
      s.idx[n] = (uint8_t)j;
      s.y[n] = values[j * in_ld + pix];
      ++n;
    }
  }
  s.n = n;

  // Stage 1 — despike (a no-op below three valid years)
  despike(s, p, ops);
  T y_range = 0, t_lo = 0, t_rng = 1, y_lo = 0, y_rng = 1;
  uint64_t vm = 0;
  if (n > 0) {
    ops.add(2LL * n + 2);
    T y_hi = s.y[0];
    y_lo = s.y[0];
    for (int i = 1; i < n; ++i) {
      y_lo = t_min(y_lo, s.y[i]);
      y_hi = t_max(y_hi, s.y[i]);
    }
    y_range = t_max(y_hi - y_lo, (T)0);
    t_lo = s.t(0);
    const T t_hi = s.t(n - 1);
    t_rng = t_hi > t_lo ? t_hi - t_lo : (T)1;
    y_rng = y_hi > y_lo ? y_hi - y_lo : (T)1;
    vm = (1ull << 0) | (1ull << (n - 1));  // one bit when n == 1
  }
  // Stage 2 — candidates + angle cull (both no-ops on fewer than 3 vertices)
  vm = find_candidates(s, vm, p, ops);
  for (int r = 0; r < p.overshoot; ++r)
    vm = remove_weakest(s, vm, p.nv, t_lo, t_rng, y_lo, y_rng, ops);
  // Stage 4a — model family, written member by member
  for (int m = 0; m < p.nm; ++m) {
    uint64_t year_word = 0;  // the member's vertex set on the year axis
    for (uint64_t w = vm; w; w &= w - 1) year_word |= 1ull << s.idx[__ffsll((long long)w) - 1];
    uint8_t* row = o.vmasks + (long long)m * ny * ld + pix;
    for (int j = 0; j < ny; ++j) row[j * ld] = (uint8_t)((year_word >> j) & 1ull);
    // below two vertices (fewer than two valid years) the fit is the
    // series itself: SSE 0, as in the plain version
    const T sse = __popcll((long long)vm) >= 2
                      ? fit_model(s, vm, y_range, p, (T*)nullptr, ops)
                      : (T)0;
    o.sses[m * ld + pix] = sse;
    if (m + 1 < p.nm) vm = remove_weakest(s, vm, 2, t_lo, t_rng, y_lo, y_rng, ops);
  }
  int c = 0;
  for (int j = 0; j < ny; ++j) {
    T v = 0;
    if (c < n && s.idx[c] == j) {
      v = s.y[c];
      ++c;
    }
    o.despiked[j * ld + pix] = v;
  }
  if (op_count != nullptr) op_count[pix] = CountOf<O>::get(ops);
}

template <typename T>
int launch_family(const void* years, const void* values, const void* mask, long long px,
                  long long in_ld, int ny, void* despiked, void* vmasks, void* sses,
                  long long out_ld, int max_segments, int overshoot, double spike, double rt,
                  int prevent, void* stream, long long* op_count) {
  Params p = {};
  p.nm = max_segments;
  p.nv = max_segments + 1;
  p.nc = max_segments + 1 + overshoot;
  p.overshoot = overshoot;
  p.spike = spike;
  p.rt = rt;
  p.prevent = prevent;
  if (ny < 1 || ny > MAX_NY || p.nc > MAX_NC || max_segments < 1 || overshoot < 0 || px < 0)
    return (int)cudaErrorInvalidValue;
  FamilyOuts<T> o;
  o.despiked = (T*)despiked;
  o.vmasks = (uint8_t*)vmasks;
  o.sses = (T*)sses;
  o.ld = out_ld;
  if (px == 0) return 0;
  const long long grid = (px + CUDA_BLOCK - 1) / CUDA_BLOCK;
  if (std::is_same<T, float>::value && op_count != nullptr) {
    family_stats_kernel<T, CountOps><<<(unsigned)grid, CUDA_BLOCK, 0, (cudaStream_t)stream>>>(
        (const T*)years, (const T*)values, (const uint8_t*)mask, px, in_ld, ny, o, p, op_count);
  } else {
    family_stats_kernel<T, NoOps><<<(unsigned)grid, CUDA_BLOCK, 0, (cudaStream_t)stream>>>(
        (const T*)years, (const T*)values, (const uint8_t*)mask, px, in_ld, ny, o, p, nullptr);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* years, const void* values, const void* mask, long long px,
           long long in_ld, int ny, void* despiked, void* fitted, void* n_vertices,
           void* vidx, void* vyear, void* vsrc, void* vfit, void* smag, void* sdur,
           void* srate, void* rmse, void* pof, void* mv, long long out_ld, int max_segments,
           int overshoot, double spike, double rt, int prevent, double pval, double bmp,
           int min_obs, int lentz_iters, void* stream, long long* op_count) {
  Params p;
  p.nm = max_segments;
  p.nv = max_segments + 1;
  p.nc = max_segments + 1 + overshoot;
  p.overshoot = overshoot;
  p.spike = spike;
  p.rt = rt;
  p.prevent = prevent;
  p.pval = pval;
  p.bmp = bmp;
  p.min_obs = min_obs;
  p.lentz_iters = lentz_iters;
  if (ny < 1 || ny > MAX_NY || p.nc > MAX_NC || max_segments < 1 || px < 0)
    return (int)cudaErrorInvalidValue;
  Outs<T> o;
  o.despiked = (T*)despiked;
  o.fitted = (T*)fitted;
  o.n_vertices = (int32_t*)n_vertices;
  o.vidx = (int32_t*)vidx;
  o.vyear = (T*)vyear;
  o.vsrc = (T*)vsrc;
  o.vfit = (T*)vfit;
  o.smag = (T*)smag;
  o.sdur = (T*)sdur;
  o.srate = (T*)srate;
  o.rmse = (T*)rmse;
  o.pof = (T*)pof;
  o.mv = (uint8_t*)mv;
  o.ld = out_ld;
  if (px == 0) return 0;
  const long long grid = (px + CUDA_BLOCK - 1) / CUDA_BLOCK;
  if (std::is_same<T, float>::value && op_count != nullptr) {
    segment_fused_kernel<T, CountOps><<<(unsigned)grid, CUDA_BLOCK, 0, (cudaStream_t)stream>>>(
        (const T*)years, (const T*)values, (const uint8_t*)mask, px, in_ld, ny, o, p, op_count);
  } else {
    segment_fused_kernel<T, NoOps><<<(unsigned)grid, CUDA_BLOCK, 0, (cudaStream_t)stream>>>(
        (const T*)years, (const T*)values, (const uint8_t*)mask, px, in_ld, ny, o, p, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define LT_ARGS                                                                              \
  const void *years, const void *values, const void *mask, long long px, long long in_ld,   \
      int ny, void *despiked, void *fitted, void *n_vertices, void *vidx, void *vyear,       \
      void *vsrc, void *vfit, void *smag, void *sdur, void *srate, void *rmse, void *pof,   \
      void *mv, long long out_ld, int max_segments, int overshoot, double spike, double rt, \
      int prevent, double pval, double bmp, int min_obs, int lentz_iters, void *stream
#define LT_PASS                                                                             \
  years, values, mask, px, in_ld, ny, despiked, fitted, n_vertices, vidx, vyear, vsrc,     \
      vfit, smag, sdur, srate, rmse, pof, mv, out_ld, max_segments, overshoot, spike, rt,   \
      prevent, pval, bmp, min_obs, lentz_iters, stream

extern "C" {

// Capacity bounds the Python wrapper checks before a launch.
int lt_segment_max_ny() { return MAX_NY; }
int lt_segment_max_nc() { return MAX_NC; }
int lt_segment_block() { return CUDA_BLOCK; }

int lt_segment_fused_f32(LT_ARGS) { return launch<float>(LT_PASS, nullptr); }
int lt_segment_fused_f64(LT_ARGS) { return launch<double>(LT_PASS, nullptr); }

// The float32 kernel with its per-pixel operation tally written to
// `op_count` (PX int64) — the roofline bound's operation count.
int lt_segment_fused_f32_opcount(LT_ARGS, void *op_count) {
  return launch<float>(LT_PASS, (long long *)op_count);
}

#define LT_FAMILY_ARGS                                                                    \
  const void *years, const void *values, const void *mask, long long px, long long in_ld, \
      int ny, void *despiked, void *vmasks, void *sses, long long out_ld, int max_segments, \
      int overshoot, double spike, double rt, int prevent, void *stream
#define LT_FAMILY_PASS                                                                   \
  years, values, mask, px, in_ld, ny, despiked, vmasks, sses, out_ld, max_segments,     \
      overshoot, spike, rt, prevent, stream

int lt_family_stats_f32(LT_FAMILY_ARGS) { return launch_family<float>(LT_FAMILY_PASS, nullptr); }
int lt_family_stats_f64(LT_FAMILY_ARGS) { return launch_family<double>(LT_FAMILY_PASS, nullptr); }

// The float32 family kernel with its per-pixel operation tally.
int lt_family_stats_f32_opcount(LT_FAMILY_ARGS, void *op_count) {
  return launch_family<float>(LT_FAMILY_PASS, (long long *)op_count);
}

}  // extern "C"
