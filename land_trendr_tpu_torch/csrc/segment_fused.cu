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
// Design, redesigned for Hopper.  One thread per pixel; blocks of 256
// threads in float32 (the fastest block that holds NY = 64 in shared
// memory: 1.31 ms against 1.66 at 128; 512 runs in 1.15 ms but fits only
// NY <= 56) and 128 in float64 (so that NY = 64 fits).
//
// Three forms.  Both kernels are instantiated three times: the narrow
// one (`Cap`), which every stack of up to 64 years with at most 16
// candidates (max_segments + 1 + vertex_count_overshoot) takes, keeps a
// vertex set and the valid-year mask in one 64-bit word; the wide one
// holds up to 128 years in two words and 32 candidates in its per-thread
// arrays, at half the block (128 threads in float32, 64 in float64) so
// that NY = 128 still fits a block's shared memory; the global one
// (`Global`) has no cap: NY, the candidate count and the block are
// runtime values.  It is the same design at a runtime width: the slab
// load, the [position][thread] columns at a 32-bit runtime stride (the
// block), the staged output, and the valid-year set as ceil(NY / 64)
// shared-memory columns of words.  Its shared tier runs the block of 128,
// 64 or 32 threads that fits the most warps on an SM (`global_block`:
// NY = 160 at 32 in float32, 64 in float64; NY = 40 at 128) and keeps
// its per-thread arrays in locals of LOCAL_NC = 64 candidates, its model
// family as member 0's vertices and the cull's removals (`FamLog`) instead
// of NM vertex sets.  Its scratch tier — a NY that no block of 32 holds
// (from 880 years in float32, 444 in float64) or more than 64 candidates —
// keeps the same layout, and the arrays, in a region of device memory per
// block, so only device memory bounds it.  The wrapper picks the form and
// the tier.  The arithmetic and its order are the same everywhere (`Store`
// gives each its storage), so each is bit-identical to the plain version.
//
// * Pixel-major I/O through shared memory.  A block's pixels are
//   contiguous rows of the caller's (PX, NY) values and bool mask, so one
//   thread issues two bulk asynchronous copies (cp.async.bulk, completion
//   counted on an mbarrier) that bring the block's slab into shared memory
//   with no transpose.  The ragged last block, or a view off 16-byte
//   alignment, loads the slab per thread instead.  `isfinite` is tested
//   here, so the wrapper hands over the caller's tensors as they are.  The
//   fused kernel writes every output pixel-major through a staging tile
//   (odd row stride, so a warp's row writes fall in 32 banks), copied out
//   in coalesced runs; the family kernel writes year-major rows, one
//   contiguous run per warp and row.
// * The series in shared memory.  Each thread compacts its row into its
//   own columns laid out [position][thread]: y (the valid years at
//   positions 0..n-1, then the raw values of the other years) and t.
//   Whatever position a lane reads, it reads its own bank; the year is
//   read directly, not through an index.  The lanes read their slab rows
//   from staggered starting years, so rows NY words apart do not collide
//   in a bank.  The slab lands in the same bytes (the mask in the y
//   columns, the values in the t columns) and the t columns become the
//   staging tile, so a block needs B * (NY + max(NY, 16) | 1) values plus
//   the year axis: 83,120 B at NY = 40, B = 256, float32 — two blocks,
//   16 warps, per SM.  What stays in local memory are the small per-pixel
//   arrays (vertex positions, segment arctangents and best points, the
//   family's words, SSEs and scores): 864 B of stack in float32.
// * The same bits with less work.  The candidate search keeps each
//   segment's farthest point and, on an insertion, recomputes only the
//   two halves of the split segment; the angle cull keeps each segment's
//   arctangent and, on a removal, recomputes only the merged segment's
//   (the TPU kernel's incremental angle table, `_remove_weakest_ys`); the
//   despike window slides in registers; the family's fits keep no
//   per-segment arrays.  Every expression and its order are unchanged
//   (ties still go to the smallest position), so float32 stays
//   bit-identical to the plain version.
//
// What bounds it on this card.  A pixel reads NY values + NY mask bytes
// and writes 2*NY + 4*NV + 3*NM + 3 words and one byte: at NY = 40,
// NV = 7, NM = 6 about 0.7 KB of device-memory traffic (f32), ~0.056 ms
// for 262,144 px at 3.35 TB/s.  Its arithmetic is ~1.3 * 10^4 FP32
// operations per pixel (seven anchored fits, the candidate-search OLS
// passes, despike trips, the Lentz scorer), about the same time at the
// FP32 peak.  The kernel runs at ~4% of that bound.  Where a thread's
// cycles go (clock64() per stage, float32, 262,144 px x 40 yr, H100 80GB
// HBM3 at 700 W): load+compact 4%, despike 10%, candidates+cull 22%,
// family fits 25%, scoring 13%, refit+output 26% — the last includes
// the wait at the output barriers for the block's slowest pixel.  What
// holds it back is the shape of the work: each thread runs a long serial
// chain whose trip counts follow its own pixel's data, so warps diverge
// and a block's output waits for its slowest pixel.  The summation order
// is part of the contract, so a warp per pixel, which would reduce in a
// tree, is not an option.
//
// A second kernel, `family_stats_kernel`, replaces the TPU kernel
// `family_stats_pallas` (land_trendr_tpu/ops/segment_pallas.py:938; body
// `_make_family_kernel`, :645, which runs `_run_stages`, :471): stages
// 1-4a unfused — the despiked series (0 at invalid years), each model-
// family member's vertex set on the year axis and the SSE of its fit.  Its
// plain version is `torch_family_stats` in ops/segment.py; it shares the
// slab load, the shared-memory series and every device function with the
// fused kernel.  It differs from the fused kernel's first half in one
// respect: it runs the family for EVERY pixel (none, one or two valid
// years, below min_observations, a flat series), as `_run_stages` does,
// where the fused kernel skips pixels the tail will call flat.  What
// bounds it: a pixel reads NY values + NY mask bytes and writes NY words,
// NM*NY vertex-set bytes and NM words — at NY = 40, NM = 6 0.62 KB (f32),
// ~0.049 ms for 262,144 px at 3.35 TB/s.
//
// A third kernel, `ftv_fit_kernel`, fits a secondary index to the
// segmentation's vertex years (FTV, fitted-trajectory values); the JAX
// package runs it as XLA (land_trendr_tpu/ops/ftv.py), and its plain
// version is ops/ftv.py:torch_fit_to_vertices.  It needs the series and
// at most NV vertices, no candidate sets, so it is built in the global
// form only (both tiers), at NV in place of the candidate count: the slab
// load, the anchored fit with its point-to-point fallback (`fit_model`,
// the refit's instantiation) and the trajectory's interpolation
// (`interp_row`) are the fused kernel's.  What bounds it: a pixel reads NY
// values, NY mask bytes and NV + 1 ints and writes NY values — at NY = 40,
// NV = 7, 392 B (f32), ~0.49 ms for 2048² px at 3.35 TB/s.
//
// A fourth kernel, `tile_index_kernel`, goes from a tile's DN bands and QA
// words to the validity mask and every spectral index the tile program
// needs, in one pass.  It replaces no Pallas kernel: the JAX package leaves
// DN scaling, the QA and range masks and the indices to XLA
// (land_trendr_tpu/ops/indices.py).  Its plain version is
// ops/indices.py:torch_tile_indices, and its results are the same bits:
// see the kernel's own note below.
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

// Capacity of one instantiation: vertex sets and the valid-year mask are
// WORDS 64-bit words (up to 64 * WORDS years), the per-thread arrays hold
// NC candidates (max_segments + 1 + overshoot) and NM = NC - 1 members.
template <int WORDS_, int NC_>
struct Cap {
  static constexpr bool GLOBAL = false;
  static constexpr bool SCRATCH = false;
  static constexpr int WORDS = WORDS_;
  static constexpr int NY = 64 * WORDS_;
  static constexpr int NC = NC_;
  static constexpr int NM = NC_ - 1;
};
using Narrow = Cap<1, 16>;  // every stack of up to 64 years, 16 candidates
using Wide = Cap<2, 32>;    // up to 128 years, 32 candidates
// Per-candidate capacity of the global form's per-thread arrays in its
// shared tier (fixed-size locals, as the fixed forms keep theirs).
constexpr int LOCAL_NC = 64;
// The global form: NY and the candidate count are runtime values, and so
// is the block (`nthreads`).  Its shared tier (SCRATCH = false) keeps the
// series and the valid-year set in dynamic shared memory, laid out as the
// fixed forms' are, and its per-thread arrays in locals of LOCAL_NC; its
// scratch tier (SCRATCH = true), for a NY whose series not even a block
// of 32 holds in shared memory or more than LOCAL_NC candidates, keeps the
// same layout, and the arrays, in a per-block region of device memory the
// launch allocates.  WORDS is a placeholder.
template <bool SCRATCH_>
struct Global {
  static constexpr bool GLOBAL = true;
  static constexpr bool SCRATCH = SCRATCH_;
  static constexpr int WORDS = 1;
  static constexpr int NY = 0x7fffffff;
  static constexpr int NC = SCRATCH_ ? 0x7fffffff : LOCAL_NC;
};
using GShared = Global<false>;
using GScratch = Global<true>;

// Threads per block.  CUDA_BLOCK is the chunk granule (every block size
// divides or is a multiple of it).  The narrow float32 kernel, the timed
// path, runs blocks of 256 (the fastest block of the sweep that holds
// NY = 64), float64 keeps 128 so that NY = 64 fits in a block's shared
// memory; the wide kernel halves both so that NY = 128 fits.  The global
// form's kernels are built for any block up to GLOBAL_MAX_BLOCK (B = 0:
// the block is blockDim.x); the launch picks it from NY, the value size
// and the candidates (`global_block`), and the scratch tier runs
// CUDA_BLOCK.
constexpr int CUDA_BLOCK = 128;
constexpr int GLOBAL_MAX_BLOCK = 128;
template <typename T, class C = Narrow>
constexpr int block_of() {
  if constexpr (C::GLOBAL) return 0;
  return (std::is_same<T, float>::value ? 2 * CUDA_BLOCK : CUDA_BLOCK) / C::WORDS;
}
constexpr long long SMEM_LIMIT = 232448;  // shared bytes one block may use on sm_90

// Threads of the block: B, or blockDim.x for the global form (B = 0).
template <int B>
__device__ __forceinline__ int nthreads() {
  if constexpr (B > 0) return B;
  else return (int)blockDim.x;
}

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

// Outputs of the fused kernel, pixel-major, each pointer at the launch's
// first pixel: row r of a (PX, w) field starts at r * w.
template <typename T>
struct Outs {
  T* despiked;         // (PX, NY)
  T* fitted;           // (PX, NY)
  int32_t* n_vertices; // (PX,)
  int32_t* vidx;       // (PX, NV)
  T* vyear;            // (PX, NV)
  T* vsrc;             // (PX, NV)
  T* vfit;             // (PX, NV)
  T* smag;             // (PX, NM)
  T* sdur;             // (PX, NM)
  T* srate;            // (PX, NM)
  T* rmse;             // (PX,)
  T* pof;              // (PX,)
  uint8_t* mv;         // (PX,)
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

// Per-thread instrumentation policy.  NoOps compiles to nothing on the
// production path.  CountOps is the floating-point operation tally for the
// roofline bound: it adds the arithmetic each loop performs on this pixel's
// data (an add, multiply, divide, compare, min/max, abs or elementary
// function each count one).  StageCycles reads clock64() at the stage
// boundaries of the fused kernel and writes each stage's cycles and their
// total (kernel entry to the last mark).
constexpr int NSTAGE = 6;  // load+compact, despike, candidates+cull, family, scoring, refit+output
enum Stage { LOAD = 0, DESPIKE, CULL, FAMILY, SCORE, OUTPUT };

struct NoOps {
  __device__ __forceinline__ void add(long long) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void write(long long*, long long) {}
};
struct CountOps {
  long long n = 0;
  __device__ __forceinline__ void add(long long k) { n += k; }
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void write(long long* out, long long pix) { out[pix] = n; }
};
struct StageCycles {
  long long cyc[NSTAGE];
  long long start, last;
  __device__ StageCycles() {
    for (int s = 0; s < NSTAGE; ++s) cyc[s] = 0;
    start = clock64();
    last = start;
  }
  __device__ __forceinline__ void add(long long) {}
  __device__ __forceinline__ void mark(int s) {
    const long long now = clock64();
    cyc[s] += now - last;
    last = now;
  }
  __device__ __forceinline__ void write(long long* out, long long pix) {
    for (int s = 0; s < NSTAGE; ++s) out[pix * (NSTAGE + 1) + s] = cyc[s];
    out[pix * (NSTAGE + 1) + NSTAGE] = last - start;
  }
};

// ---- shared memory of one block -------------------------------------------
// Dynamic shared memory of a block of B threads at NY years, element size E:
//   [mbarrier, 16 B][year axis, NY * E rounded up to 16 B]
//   [y columns, NY * B * E]: the mask slab lands here first;
//   [t columns, W * B * E]: the value slab lands here first, and the
//    output staging tile reuses it at the end (W = max(NY, NC) | 1 for the
//    instantiation's candidate capacity NC, an odd row stride, so a warp's
//    row writes fall in 32 banks).
// A thread's column holds position i at [i * B + threadIdx.x]: whatever
// position each lane reads, it reads its own bank.
__host__ __device__ constexpr int stage_width(int ny, int nc) { return (ny > nc ? ny : nc) | 1; }
__host__ __device__ constexpr long long smem_bytes(int ny, int elem, int block, int nc) {
  return 16 + ((long long)ny * elem + 15) / 16 * 16 +
         (long long)block * (ny + stage_width(ny, nc)) * elem;
}
// The global form's block adds the valid-year set as W = ceil(NY / 64)
// columns of 64-bit words, between the year axis and the y columns (the
// fixed forms hold it in registers):
//   [mbarrier][year axis][valid words, W * B * 8][y columns][t columns]
// with the t columns' width max(NY, NC) | 1 for the launch's NC.
__host__ __device__ constexpr int words_of(int ny) { return (ny + 63) / 64; }
__host__ __device__ constexpr long long global_smem_bytes(int ny, int nc, int elem, int block) {
  return smem_bytes(ny, elem, block, nc) + (long long)words_of(ny) * block * 8;
}
// The shared tier's block size: of the blocks of 128, 64 and 32 threads
// that fit in shared memory, the one an SM holds the most warps of (its
// 233,472 shared bytes, 1,024 of them kept by the system per resident
// block, at most 32 blocks and 64 warps), ties to the larger block — at
// NY = 160 in float32 that is 32 (5 warps against 4), at NY = 40 128; 0
// (the scratch tier) when none fits or the candidates exceed the local
// arrays.
constexpr long long SM_SMEM = 233472;
constexpr int global_block(int ny, int elem, int nc) {
  if (nc > LOCAL_NC) return 0;
  int best = 0, best_warps = 0;
  for (int b = GLOBAL_MAX_BLOCK; b >= 32; b /= 2) {
    const long long bytes = global_smem_bytes(ny, nc, elem, b);
    if (bytes > SMEM_LIMIT) continue;
    long long blocks = SM_SMEM / (bytes + 1024);
    if (blocks > 32) blocks = 32;
    if (blocks > 2048 / b) blocks = 2048 / b;
    const int warps = (int)blocks * b / 32;
    if (warps > best_warps) {
      best = b;
      best_warps = warps;
    }
  }
  return best;
}

// A set of year indices or compacted positions: W 64-bit words, bit j of
// the set in word j / 64.  The one-word forms are the plain 64-bit
// expressions, so the narrow instantiation compiles as a single word.
template <int W>
struct Bits {
  uint64_t w[W];
  __device__ __forceinline__ static Bits none() {
    Bits b;
    for (int q = 0; q < W; ++q) b.w[q] = 0;
    return b;
  }
  __device__ __forceinline__ void clear() {
    for (int q = 0; q < W; ++q) w[q] = 0;
  }
  __device__ __forceinline__ void set(int j) {
    if constexpr (W == 1) {
      w[0] |= 1ull << j;
    } else {
      for (int q = 0; q < W; ++q) {  // constant indices: the words stay in registers
        if (q == (j >> 6)) w[q] |= 1ull << (j & 63);
      }
    }
  }
  __device__ __forceinline__ bool test(int j) const {
    if constexpr (W == 1) {
      return (w[0] >> j) & 1ull;
    } else {
      uint64_t x = 0;
      for (int q = 0; q < W; ++q) {
        if (q == (j >> 6)) x = w[q];
      }
      return (x >> (j & 63)) & 1ull;
    }
  }
  __device__ __forceinline__ int count() const {
    int c = 0;
    for (int q = 0; q < W; ++q) c += __popcll((long long)w[q]);
    return c;
  }
  // members below j
  __device__ __forceinline__ int count_below(int j) const {
    if constexpr (W == 1) {
      return __popcll((long long)(w[0] & ((1ull << j) - 1ull)));
    } else {
      const int q = j >> 6;
      int c = 0;
      for (int i = 0; i < W; ++i) {
        if (i < q) c += __popcll((long long)w[i]);
      }
      for (int i = 0; i < W; ++i) {
        if (i == q) c += __popcll((long long)(w[i] & ((1ull << (j & 63)) - 1ull)));
      }
      return c;
    }
  }
  // the largest member (the set is not empty)
  __device__ __forceinline__ int highest() const {
    for (int q = W - 1; q > 0; --q) {
      if (w[q]) return 64 * q + 63 - __clzll((long long)w[q]);
    }
    return 63 - __clzll((long long)w[0]);
  }
  // calls f(j) for each member j, ascending
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    for (int q = 0; q < W; ++q) {
      for (uint64_t x = w[q]; x; x &= x - 1) f(64 * q + __ffsll((long long)x) - 1);
    }
  }
};

// ---- storage of the global form -------------------------------------------
// A set of the global form: nw words in the thread's column of its block
// (shared memory, or the scratch tier's region), word q at w[q * ld] with
// ld the block's threads, so the lanes of a warp touch adjacent words.
// The same members as Bits<W>, over a runtime word count.
struct GBits {
  uint64_t* w;
  int nw;
  int ld;
  __device__ __forceinline__ static GBits none() { return GBits{nullptr, 0, 0}; }
  __device__ __forceinline__ uint64_t& word(int q) const { return w[q * ld]; }
  __device__ __forceinline__ void clear() const {
    for (int q = 0; q < nw; ++q) word(q) = 0;
  }
  __device__ __forceinline__ void set(int j) const { word(j >> 6) |= 1ull << (j & 63); }
  __device__ __forceinline__ bool test(int j) const { return (word(j >> 6) >> (j & 63)) & 1ull; }
  __device__ __forceinline__ int count() const {
    int c = 0;
    for (int q = 0; q < nw; ++q) c += __popcll((long long)word(q));
    return c;
  }
  __device__ __forceinline__ int count_below(int j) const {
    const int q = j >> 6;
    int c = 0;
    for (int i = 0; i < q; ++i) c += __popcll((long long)word(i));
    return c + __popcll((long long)(word(q) & ((1ull << (j & 63)) - 1ull)));
  }
  __device__ __forceinline__ int highest() const {
    for (int q = nw - 1; q > 0; --q) {
      const uint64_t x = word(q);
      if (x) return 64 * q + 63 - __clzll((long long)x);
    }
    return 63 - __clzll((long long)word(0));
  }
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    for (int q = 0; q < nw; ++q) {
      for (uint64_t x = word(q); x; x &= x - 1) f(64 * q + __ffsll((long long)x) - 1);
    }
  }
};

// A per-thread array of N values (registers or local memory) ...
template <typename U, int N>
struct Local {
  U a[N];
  __device__ __forceinline__ U& operator[](int i) { return a[i]; }
  __device__ __forceinline__ const U& operator[](int i) const { return a[i]; }
};
// ... and the scratch tier's form: the thread's column of its block's
// region, element i at p[i * ld] (ld = the block's threads).
template <typename U>
struct Strided {
  U* p;
  int ld;
  __device__ __forceinline__ U& operator[](int i) const { return p[i * ld]; }
};

// NM sets of one thread, in registers.
template <int W, int N>
struct LocalSets {
  Bits<W> a[N];
  __device__ __forceinline__ Bits<W>& operator[](int m) { return a[m]; }
  __device__ __forceinline__ const Bits<W>& operator[](int m) const { return a[m]; }
};

// The global form's model family: each member is the one before it less
// the vertex the cull removed after it, so the family is member 0's
// vertices and the removals — NC + NM positions where NM sets would take
// NM * NY bits.
template <class IArr>
struct FamLog {
  int k0 = 0;  // member 0's vertex count
  IArr rm;   // rm[m]: the position removed after member m (-1: none)
  // member 0's vertices (the cull's live set), into vp
  template <class V, class A>
  __device__ __forceinline__ void start(const V& v, A& vp) {
    k0 = v.k;
    for (int j = 0; j < k0; ++j) vp[j] = v.vp[j];
  }
  // member m's vertices, ascending: member 0's (in vp) less the first m
  // removals, in place; returns their count
  template <class A>
  __device__ __forceinline__ int member(int m, A& vp) const {
    int k = 0;
    for (int j = 0; j < k0; ++j) {
      const int x = vp[j];
      bool gone = false;
      for (int q = 0; q < m; ++q) gone = gone || rm[q] == x;
      if (!gone) vp[k++] = x;
    }
    return k;
  }
};

// The storage types of capacity C: fixed-size arrays for Cap and for the
// global form's shared tier (LOCAL_NC each), views of the block's region
// for its scratch tier.
template <class C>
struct Store {
  using Set = Bits<C::WORDS>;
  using Sets = LocalSets<C::WORDS, C::NM>;
  template <typename U>
  using Arr = Local<U, C::NC>;  // one per candidate
  template <typename U>
  using MArr = Local<U, C::NM>;  // one per family member
};
template <bool S>
struct Store<Global<S>> {
  using Set = GBits;
  template <typename U>
  using Arr = std::conditional_t<S, Strided<U>, Local<U, LOCAL_NC>>;
  template <typename U>
  using MArr = Arr<U>;
  using Sets = FamLog<Arr<int>>;
};

// The scratch tier's per-thread arrays, after the block's layout
// (global_smem_bytes) in its region: one plane per array, laid out
// [position][thread], the int planes first.
enum Plane {
  P_VP,      // nc ints: live vertices
  P_SI,      // nc ints: each segment's farthest point
  P_RVP,     // nc ints: the chosen model's vertices
  P_VYI,     // nc ints: each vertex's year index
  P_FRM,     // nm ints: the vertex removed after each family member
  P_SDEV,    // nc values: each segment's deviation, then its arctangent
  P_RVF,     // nc values: the chosen model's fitted values
  P_VREG,    // nc values: the refit's regression anchors
  P_RATE,    // nc values: the refit's point-to-point rates
  P_FSSE,    // nm values: the family's SSEs,
  P_FP,      // nm values: p-values,
  P_FSCORE,  // nm values: scores
  NPLANE
};
// Byte offset of `plane` from the arrays' start (NPLANE: their size) for a
// block of `block` threads; every plane is a multiple of 128 bytes.
__host__ __device__ constexpr long long plane_offset(int plane, int nc, int nm, int elem,
                                                     int block) {
  const long long ints = plane <= P_VYI ? (long long)plane * nc
                       : plane == P_FRM ? 4LL * nc
                       : 4LL * nc + nm;
  const long long vals = plane <= P_FRM ? 0
                       : plane <= P_RATE ? (long long)(plane - P_SDEV) * nc
                       : 4LL * nc + (long long)(plane - P_FSSE) * nm;
  return (ints * 4 + vals * elem) * block;
}
// Bytes of one block's region in the scratch tier: the block's layout,
// then its arrays.
__host__ __device__ constexpr long long global_region_bytes(int ny, int nc, int nm, int elem,
                                                            int block) {
  return global_smem_bytes(ny, nc, elem, block) + plane_offset(NPLANE, nc, nm, elem, block);
}

// One thread's views of its block's arrays in the scratch tier (nothing
// for the other forms).
template <typename T, class C>
struct Mem {
  __device__ Mem(unsigned char*, int, int, const Params&) {}
};
template <typename T>
struct Mem<T, GScratch> {
  unsigned char* arrays;  // the block's arrays
  int nc, nm, nb;
  __device__ Mem(unsigned char* region, int ny, int nb_, const Params& p)
      : arrays(region + global_smem_bytes(ny, p.nc, (int)sizeof(T), nb_)),
        nc(p.nc), nm(p.nm), nb(nb_) {}
  template <typename U>
  __device__ __forceinline__ Strided<U> arr(int q) const {
    return Strided<U>{
        reinterpret_cast<U*>(arrays + plane_offset(q, nc, nm, (int)sizeof(T), nb)) + threadIdx.x,
        nb};
  }
};

template <typename T, int B>
struct Block {
  uint64_t* bar;
  T* ts;      // year axis (uncompacted)
  T* ycol;    // y columns; the mask slab on arrival
  T* region;  // t columns; the value slab on arrival; the staging tile at the end
  __device__ Block(unsigned char* smem, int ny) {
    bar = reinterpret_cast<uint64_t*>(smem);
    ts = reinterpret_cast<T*>(smem + 16);
    ycol = reinterpret_cast<T*>(smem + 16 + (ny * (int)sizeof(T) + 15) / 16 * 16);
    region = ycol + ny * B;
  }
};
// The global form's block (B = 0: blockDim.x threads), with its valid-year
// words between the year axis and the y columns.
template <typename T>
struct Block<T, 0> {
  uint64_t* bar;
  T* ts;
  uint64_t* vw;  // the valid-year words
  T* ycol;
  T* region;
  __device__ Block(unsigned char* smem, int ny) {
    const int nb = nthreads<0>();
    bar = reinterpret_cast<uint64_t*>(smem);
    ts = reinterpret_cast<T*>(smem + 16);
    vw = reinterpret_cast<uint64_t*>(smem + 16 + (ny * (int)sizeof(T) + 15) / 16 * 16);
    ycol = reinterpret_cast<T*>(vw + words_of(ny) * nb);
    region = ycol + ny * nb;
  }
};

// The global form's valid-year set of the thread, empty: its words in
// the block's columns.
template <typename T>
__device__ __forceinline__ GBits global_valid_set(const Block<T, 0>& blk, int ny) {
  const GBits b{blk.vw + threadIdx.x, words_of(ny), nthreads<0>()};
  b.clear();
  return b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Bulk asynchronous copy (the Tensor Memory Accelerator's 1-D form) of
// `bytes` contiguous bytes, completion counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Bring the block's slab — `npx` contiguous pixel rows of NY values and NY
// mask bytes — into its memory and compact each live thread's row into
// its columns: the valid years (mask set, value finite) at positions
// 0..n-1 in year order, then the raw values of the other years in year
// order.  Fills the year axis and the t columns; returns the thread's
// valid-year set (capacity C's).  The block's memory is shared memory but
// in the global form's scratch tier, so an aligned slab comes in by bulk
// copy.  Every thread of the block must call it.
template <typename T, int B, class C>
__device__ typename Store<C>::Set load_compact(const Block<T, B>& blk, const T* __restrict__ years,
                                               const T* __restrict__ vals,
                                               const uint8_t* __restrict__ mask, int npx,
                                               int ny) {
  const int nb = nthreads<B>();
  const int r = threadIdx.x;
  T* vland = blk.region;
  uint8_t* mland = reinterpret_cast<uint8_t*>(blk.ycol);
  const uint32_t vbytes = (uint32_t)npx * (uint32_t)ny * (uint32_t)sizeof(T);
  const uint32_t mbytes = (uint32_t)npx * (uint32_t)ny;
  // one bulk copy each when both slabs are whole 16-byte runs; the ragged
  // last block of an odd-sized call, or an unaligned view, loads per thread
  const bool bulk =
      !C::SCRATCH && ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(mask) |
                       vbytes | mbytes) & 15u) == 0;
  for (int j = r; j < ny; j += nb) blk.ts[j] = years[j];
  if (bulk) {
    if (r == 0) mbar_init(blk.bar);
  } else {
    for (int e = r; e < npx * ny; e += nb) vland[e] = vals[e];
    for (int e = r; e < npx * ny; e += nb) mland[e] = mask[e];
  }
  __syncthreads();
  if (bulk) {
    if (r == 0) {
      mbar_expect_tx(blk.bar, vbytes + mbytes);
      bulk_load(vland, vals, vbytes, blk.bar);
      bulk_load(mland, mask, mbytes, blk.bar);
    }
    mbar_wait(blk.bar, 0);
  }
  const bool live = r < npx;
  // each lane reads its row from its own starting year, so that the lanes
  // of a warp (rows NY apart) fall in different banks
  const int j0 = live ? r % ny : 0;
  const T* vrow = vland + r * ny;
  // (the fixed forms' set starts as none() in registers, as it was; a
  // helper returning either kind of set changed their code)
  typename Store<C>::Set valid = Store<C>::Set::none();
  if constexpr (C::GLOBAL) valid = global_valid_set(blk, ny);
  if (live) {
    const uint8_t* mrow = mland + r * ny;
    for (int c = 0, j = j0; c < ny; ++c) {
      if (mrow[j] && isfinite(vrow[j])) valid.set(j);
      if (++j == ny) j = 0;
    }
  }
  __syncthreads();  // the mask slab is read: its bytes become the y columns
  const int n = valid.count();
  if (live) {
    for (int c = 0, j = j0; c < ny; ++c) {
      const int below = valid.count_below(j);
      const int pos = valid.test(j) ? below : n + (j - below);
      blk.ycol[pos * nb + r] = vrow[j];
      if (++j == ny) j = 0;
    }
  }
  __syncthreads();  // the value slab is read: its bytes become the t columns
  if (live) {
    int i = 0;
    valid.each([&](int j) { blk.region[(i++) * nb + r] = blk.ts[j]; });
  }
  return valid;
}

// Year index of the i-th (from 0) set bit of `w`.
__device__ __forceinline__ int nth_bit(uint64_t w, int i) {
  const uint32_t lo = (uint32_t)w;
  const int c = __popc(lo);
  return i < c ? (int)__fns(lo, 0, i + 1) : 32 + (int)__fns((uint32_t)(w >> 32), 0, i - c + 1);
}

// Index of the i-th (from 0) member of `b`.
template <int W>
__device__ __forceinline__ int nth_bit(const Bits<W>& b, int i) {
  if constexpr (W == 1) {
    return nth_bit(b.w[0], i);
  } else {
    int base = 0;
    for (int q = 0; q < W - 1; ++q) {
      const int c = __popcll((long long)b.w[q]);
      if (i < c) return base + nth_bit(b.w[q], i);
      i -= c;
      base += 64;
    }
    return base + nth_bit(b.w[W - 1], i);
  }
}

__device__ __forceinline__ int nth_bit(const GBits& b, int i) {
  int base = 0;
  for (int q = 0; q < b.nw - 1; ++q) {
    const uint64_t x = b.word(q);
    const int c = __popcll((long long)x);
    if (i < c) return base + nth_bit(x, i);
    i -= c;
    base += 64;
  }
  return base + nth_bit(b.word(b.nw - 1), i);
}

// Members of `vm`, ascending, into vp; returns the count.
template <class S, class A>
__device__ __forceinline__ int bit_positions(const S& vm, A& vp) {
  int k = 0;
  vm.each([&](int b) { vp[k++] = b; });
  return k;
}

// One thread's view of its pixel's compacted series in its columns: the
// stride is the block B, or (B = 0, the global form) its runtime block
// `ld`.
template <typename T, int B>
struct Series {
  T* yc;        // y at position i: yc[i * B] (despiked in place)
  const T* tc;  // t at position i: tc[i * B]
  int n;        // valid years
  std::conditional_t<(B > 0), long long, int> ld;
  __device__ __forceinline__ T& y(int i) {
    if constexpr (B > 0) return yc[i * B];
    else return yc[i * ld];
  }
  __device__ __forceinline__ T y(int i) const {
    if constexpr (B > 0) return yc[i * B];
    else return yc[i * ld];
  }
  __device__ __forceinline__ T t(int i) const {
    if constexpr (B > 0) return tc[i * B];
    else return tc[i * ld];
  }
};

template <typename T>
__device__ __forceinline__ T clamp_slope(T slope, T duration, T y_range, const Params& p) {
  T limit = -(T)p.rt * y_range;
  T clamped = t_max(slope, limit);
  if (p.prevent) clamped = duration <= (T)1 ? (T)0 : clamped;
  bool active = (slope < (T)0) && (y_range > (T)0);
  return active ? clamped : slope;
}

// OLS over compacted positions [a, b]: slope, tm, ym.  The line is
// ym + c1 * (t - tm), in the frame centred on the segment: an intercept at
// year 0 would amplify the slope's last bit by tm (~2000).
template <typename T, int B, class O>
__device__ void ols(const Series<T, B>& s, int a, int b, T& c1, T& tm, T& ym, O& ops) {
  ops.add(9LL * (b - a + 1) + 5);
  T n = 0, st = 0, sy = 0;
  for (int i = a; i <= b; ++i) {
    n = n + (T)1;
    st = st + s.t(i);
    sy = sy + s.y(i);
  }
  T n_safe = n < (T)1 ? (T)1 : n;
  tm = st / n_safe;
  ym = sy / n_safe;
  T stt = 0, sty = 0;
  for (int i = a; i <= b; ++i) {
    T d = s.t(i) - tm;
    stt = stt + d * d;
    sty = sty + d * (s.y(i) - ym);
  }
  bool ok = (n >= (T)2) && (stt > (T)0);
  c1 = ok ? sty / stt : (T)0;
}

// Stage 1: iteratively damp the largest interior spike (oracle despike).
// The three-point window slides along the series in registers.
template <typename T, int B, class O>
__device__ void despike(Series<T, B>& s, const Params& p, O& ops) {
  const int n = s.n;
  const T thr = (T)p.spike;
  for (int it = 0; it < n; ++it) {
    ops.add(15LL * (n > 2 ? n - 2 : 0) + 4);
    T best = (T)-1, best_itp = 0;
    int bi = -1;
    if (n > 2) {
      T tp = s.t(0), ti = s.t(1), yp = s.y(0), yi = s.y(1);
      for (int i = 1; i <= n - 2; ++i) {
        const T tq = s.t(i + 1), yq = s.y(i + 1);
        T itp = yp + (yq - yp) * (ti - tp) / (tq - tp);
        T dev = f_abs(yi - itp);
        T crossing = f_abs(yq - yp);
        T prop = dev > (T)0 ? t_max((T)0, (T)1 - crossing / dev) : (T)0;
        if (prop > best) {
          best = prop;
          bi = i;
          best_itp = itp;
        }
        tp = ti;
        ti = tq;
        yp = yi;
        yi = yq;
      }
    }
    if (!(best > thr)) break;
    s.y(bi) = s.y(bi) + (best_itp - s.y(bi)) * best;
  }
}

// Candidate and cull state of one pixel: the live vertices (compacted
// positions, ascending) and, once the cull starts, the arctangent of each
// segment's slope in the frame normalised by (t_lo, t_rng, y_lo, y_rng).
template <typename T, class C>
struct Verts {
  using IArr = typename Store<C>::template Arr<int>;
  using TArr = typename Store<C>::template Arr<T>;
  int k;
  IArr vp;
  IArr si;      // candidate search: where segment g's largest deviation lies
  union {
    TArr sdev;  // candidate search: segment g's largest deviation
    TArr sa;    // cull: sa[g] for segment g = (vp[g], vp[g + 1])
  };
  T t_lo, t_rng, y_lo, y_rng;
  // the scratch tier's arrays are views of the block's region
  template <class M>
  __device__ __forceinline__ void bind(const M& mem) {
    if constexpr (C::SCRATCH) {
      vp = mem.template arr<int>(P_VP);
      si = mem.template arr<int>(P_SI);
      sdev = mem.template arr<T>(P_SDEV);
    }
  }
  // the vertex set, into b
  template <class S>
  __device__ __forceinline__ void word_into(S&& b) const {
    b.clear();
    for (int j = 0; j < k; ++j) b.set(vp[j]);
  }
};

// The interior point of segment (a, b) farthest from its OLS line: the
// first of the largest, -1 when the segment has no interior point.
template <typename T, int B, class O>
__device__ void seg_best(const Series<T, B>& s, int a, int b, T& dev_best, int& i_best, O& ops) {
  dev_best = (T)-1;
  i_best = -1;
  if (b - a < 2) return;
  T c1, tm, ym;
  ols(s, a, b, c1, tm, ym, ops);
  ops.add(6LL * (b - a - 1));
  for (int i = a + 1; i < b; ++i) {
    T dev = f_abs(s.y(i) - (ym + c1 * (s.t(i) - tm)));
    if (dev > dev_best) {
      dev_best = dev;
      i_best = i;
    }
  }
}

// Stage 2: grow the vertex set by max-deviation insertion.  Each
// segment's best point is kept; an insertion recomputes only the two
// segments it splits.  The pick is the first of the largest over segments
// in order, which is the first of the largest over all positions — the
// full rescan's answer.
template <typename T, int B, class C, class O>
__device__ void find_candidates(const Series<T, B>& s, Verts<T, C>& v, const Params& p, O& ops) {
  for (int g = 0; g + 1 < v.k; ++g) seg_best(s, v.vp[g], v.vp[g + 1], v.sdev[g], v.si[g], ops);
  for (int trip = 0; trip < p.nc - 2; ++trip) {
    T best = (T)-1;
    int gb = -1;
    for (int g = 0; g + 1 < v.k; ++g) {
      if (v.sdev[g] > best) {
        best = v.sdev[g];
        gb = g;
      }
    }
    if (gb < 0) break;  // no interior year left anywhere: later trips are no-ops
    const int bi = v.si[gb];
    for (int g = v.k - 1; g > gb + 1; --g) {
      v.sdev[g] = v.sdev[g - 1];
      v.si[g] = v.si[g - 1];
    }
    for (int j = v.k; j > gb + 1; --j) v.vp[j] = v.vp[j - 1];
    v.vp[gb + 1] = bi;
    ++v.k;
    seg_best(s, v.vp[gb], v.vp[gb + 1], v.sdev[gb], v.si[gb], ops);
    seg_best(s, v.vp[gb + 1], v.vp[gb + 2], v.sdev[gb + 1], v.si[gb + 1], ops);
  }
}

// Arctangent of the slope of segment (a, b) in the normalised frame.  The
// angle at vertex j is |sa[j] - sa[j - 1]|: the same expression as a full
// rebuild computes, so an incremental update gives the same bits.
template <typename T, int B, class C, class O>
__device__ __forceinline__ T seg_atan(const Series<T, B>& s, const Verts<T, C>& v, int a, int b,
                                      O& ops) {
  ops.add(12);
  const T xa = (s.t(a) - v.t_lo) / v.t_rng, ya = (s.y(a) - v.y_lo) / v.y_rng;
  const T xb = (s.t(b) - v.t_lo) / v.t_rng, yb = (s.y(b) - v.y_lo) / v.y_rng;
  return f_atan((yb - ya) / (xb - xa));
}

template <typename T, int B, class C, class O>
__device__ void cull_init(const Series<T, B>& s, Verts<T, C>& v, O& ops) {
  if (v.k < 3) return;  // no interior vertex: nothing is ever removed
  for (int g = 0; g + 1 < v.k; ++g) v.sa[g] = seg_atan(s, v, v.vp[g], v.vp[g + 1], ops);
}

// Drop the min-angle interior vertex (the first of the smallest) while the
// count exceeds keep_above (>= 2); only the merged segment's arctangent is
// recomputed.  The global form's returns the removed vertex's position,
// -1 when none was.
template <typename T, int B, class C, class O>
__device__ std::conditional_t<C::GLOBAL, int, void> remove_weakest(const Series<T, B>& s,
                                                                   Verts<T, C>& v,
                                                                   int keep_above, O& ops) {
  const int k = v.k;
  if (k <= keep_above) {
    if constexpr (C::GLOBAL) return -1;
    else return;
  }
  ops.add(3LL * (k - 2));
  T best = 0;
  int jmin = -1;
  for (int j = 1; j <= k - 2; ++j) {
    const T ang = f_abs(v.sa[j] - v.sa[j - 1]);
    if (jmin < 0 || ang < best) {
      best = ang;
      jmin = j;
    }
  }
  const int gone = v.vp[jmin];
  for (int j = jmin; j + 1 < k; ++j) v.vp[j] = v.vp[j + 1];
  for (int g = jmin; g + 2 < k; ++g) v.sa[g] = v.sa[g + 1];
  v.k = k - 1;
  v.sa[jmin - 1] = seg_atan(s, v, v.vp[jmin - 1], v.vp[jmin], ops);
  if constexpr (C::GLOBAL) return gone;
}

// Anchored fit + point-to-point fallback for the vertices vp[0..k-1].
// Returns the SSE over the vertex span; the REFIT instantiation also
// writes the fitted value at each vertex to `vf` (the chosen model's
// refit), and only it keeps the per-segment anchors and rates.
template <bool REFIT, class C, typename T, int B, class VP, class VF, class M, class O>
__device__ T fit_model(const Series<T, B>& s, const VP& vp, const int k, T y_range,
                       const Params& p, VF& vf, const M& mem, O& ops) {
  // per-vertex arrays of the refit, in the block's region in the scratch tier
  using Keep = std::conditional_t<C::SCRATCH, Strided<T>, Local<T, REFIT ? C::NC : 1>>;
  // regression: 6 per year per pass (two passes after segment 0's OLS,
  // whose residual pass is 7 per year in the centred frame); p2p: 6 per
  // year; ~24 per vertex for slopes, clamps, rates and anchors
  ops.add(12LL * (vp[k - 1] - vp[1]) + 7LL * (vp[1] - vp[0] + 1) +
          6LL * (vp[k - 1] - vp[0] + 1) + 24LL * k + 4);
  // --- segment 0: OLS over closed [v0, v1] ---
  T c1, tm, ym;
  ols(s, vp[0], vp[1], c1, tm, ym, ops);
  T c1c = clamp_slope(c1, s.t(vp[1]) - s.t(vp[0]), y_range, p);
  T sse_reg = 0;
  for (int i = vp[0]; i <= vp[1]; ++i) {
    T r = s.y(i) - (ym + c1c * (s.t(i) - tm));
    sse_reg = sse_reg + r * r;
  }
  Keep vreg, rate;
  if constexpr (REFIT && C::SCRATCH) {
    vreg = mem.template arr<T>(P_VREG);
    rate = mem.template arr<T>(P_RATE);
  }
  if constexpr (REFIT) vreg[0] = ym + c1c * (s.t(vp[0]) - tm);
  T anchor_t = s.t(vp[1]);
  T anchor_y = ym + c1c * (anchor_t - tm);
  if constexpr (REFIT) vreg[1] = anchor_y;
  // --- segments 1..: slope-only regression through the anchor ---
  for (int g = 1; g + 1 < k; ++g) {
    const int a = vp[g], b = vp[g + 1];
    T denom = 0, num = 0;
    for (int i = a + 1; i <= b; ++i) {
      T dt = s.t(i) - anchor_t;
      denom = denom + dt * dt;
      num = num + dt * (s.y(i) - anchor_y);
    }
    T slope = denom > (T)0 ? num / denom : (T)0;
    T tb = s.t(b);
    slope = clamp_slope(slope, tb - anchor_t, y_range, p);
    for (int i = a + 1; i <= b; ++i) {
      T r = s.y(i) - (anchor_y + slope * (s.t(i) - anchor_t));
      sse_reg = sse_reg + r * r;
    }
    T new_anchor_y = anchor_y + slope * (tb - anchor_t);
    anchor_t = tb;
    anchor_y = new_anchor_y;
    if constexpr (REFIT) vreg[g + 1] = anchor_y;
  }
  // --- point-to-point fallback: segment by segment, in year order ---
  bool p2p_ok = true;
  const T rt = (T)p.rt, eps = (T)EPS_RATE;
  T sse_p2p = 0;
  for (int g = 0; g + 1 < k; ++g) {
    const int a = vp[g];
    const T ya = s.y(a), ta = s.t(a);
    T dur = s.t(vp[g + 1]) - ta;
    T dy = s.y(vp[g + 1]) - ya;
    bool pos = dur > (T)0;
    bool viol = (dy < (T)0) && (y_range > (T)0) && pos;
    bool fast = (-dy) / (pos ? dur : (T)1) > rt * y_range + eps;
    if (p.prevent) fast = fast || (dur <= (T)1);
    if (viol && fast) p2p_ok = false;
    const T rate_g = pos ? dy / dur : (T)0;
    if constexpr (REFIT) rate[g] = rate_g;
    const int end = (g + 2 == k) ? vp[g + 1] : vp[g + 1] - 1;
    for (int i = a; i <= end; ++i) {
      T r = s.y(i) - (ya + rate_g * (s.t(i) - ta));
      sse_p2p = sse_p2p + r * r;
    }
  }
  const bool use_p2p = p2p_ok && (sse_p2p < sse_reg);
  if constexpr (REFIT) {
    for (int j = 0; j < k; ++j) {
      if (use_p2p) {
        const int g = j + 1 < k ? j : k - 2;  // the last vertex ends the last segment
        vf[j] = s.y(vp[g]) + rate[g] * (s.t(vp[j]) - s.t(vp[g]));
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

// What one pixel's thread carries from its compute into the output phase.
template <typename T, class C>
struct PixelResult {
  bool mv;
  int k;                                  // vertices of the chosen model (0: the flat model)
  typename Store<C>::template Arr<int> vp;  // their compacted positions
  typename Store<C>::template Arr<T> vf;    // their fitted values
  T mean, rmse, pof;
  template <class M>
  __device__ __forceinline__ void bind(const M& mem) {
    if constexpr (C::SCRATCH) {
      vp = mem.template arr<int>(P_RVP);
      vf = mem.template arr<T>(P_RVF);
    }
  }
};

// Stages 1-5 of one pixel: despike, candidates + cull, the model family,
// scoring + selection, and the chosen member's refit (or the flat model).
template <typename T, int B, class C, class M, class O>
__device__ void segment_pixel(Series<T, B>& s, int ny, const Params& p, PixelResult<T, C>& res,
                              const M& mem, O& ops) {
  const int n = s.n;
  const bool enough = n >= p.min_obs;
  const T n_f = (T)n;
  const T n_safe = n_f < (T)1 ? (T)1 : n_f;
  res.mv = false;
  if (enough) {
    despike(s, p, ops);
    ops.mark(DESPIKE);
    ops.add(2LL * n + 2);
    T y_lo = s.y(0), y_hi = s.y(0);
    for (int i = 1; i < n; ++i) {
      y_lo = t_min(y_lo, s.y(i));
      y_hi = t_max(y_hi, s.y(i));
    }
    const T y_range = t_max(y_hi - y_lo, (T)0);
    if (y_range > (T)0) {
      // Stage 2 — candidates + angle cull
      Verts<T, C> v;
      v.bind(mem);
      v.t_lo = s.t(0);
      const T t_hi = s.t(n - 1);
      v.t_rng = t_hi > v.t_lo ? t_hi - v.t_lo : (T)1;
      v.y_lo = y_lo;
      v.y_rng = y_hi > y_lo ? y_hi - y_lo : (T)1;
      v.vp[0] = 0;
      v.vp[1] = n - 1;
      v.k = n > 1 ? 2 : 1;
      ops.add(4);
      find_candidates(s, v, p, ops);
      cull_init(s, v, ops);
      for (int r = 0; r < p.overshoot; ++r) remove_weakest(s, v, p.nv, ops);
      ops.mark(CULL);
      // Stage 4 — model family: vertex word + SSE per member (the global
      // form: member 0's vertices, in res.vp, and the removals)
      typename Store<C>::Sets fam_vm;
      typename Store<C>::template MArr<T> fam_sse, fam_p, fam_score;
      if constexpr (C::SCRATCH) {
        fam_vm.rm = mem.template arr<int>(P_FRM);
        fam_sse = mem.template arr<T>(P_FSSE);
        fam_p = mem.template arr<T>(P_FP);
        fam_score = mem.template arr<T>(P_FSCORE);
      }
      T* const no_vf = nullptr;
      for (int m = 0; m < p.nm; ++m) {
        if constexpr (C::GLOBAL) {
          if (m == 0) fam_vm.start(v, res.vp);
        } else {
          v.word_into(fam_vm[m]);
        }
        fam_sse[m] = fit_model<false, C>(s, v.vp, v.k, y_range, p, no_vf, mem, ops);
        if (m + 1 < p.nm) {
          if constexpr (C::GLOBAL) {
            fam_vm.rm[m] = remove_weakest(s, v, 2, ops);
          } else {
            remove_weakest(s, v, 2, ops);
          }
        }
      }
      ops.mark(FAMILY);
      // scoring + selection
      ops.add(4LL * n + 1 + 2LL * p.nm);
      T sum_y = 0;
      for (int i = 0; i < n; ++i) sum_y = sum_y + s.y(i);
      const T mean0 = sum_y / n_safe;
      T ss0 = 0;
      for (int i = 0; i < n; ++i) {
        T d = s.y(i) - mean0;
        ss0 = ss0 + d * d;
      }
      T best = 0;
      int km = 0;  // the global form: member m's vertex count
      if constexpr (C::GLOBAL) km = fam_vm.k0;
      for (int m = 0; m < p.nm; ++m) {
        T ms;
        if constexpr (C::GLOBAL) {
          ms = (T)(km - 1);
          if (m + 1 < p.nm && fam_vm.rm[m] >= 0) --km;
        } else {
          ms = (T)(fam_vm[m].count() - 1);
        }
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
      ops.mark(SCORE);
      if (p_c <= (T)p.pval) {
        // refit the chosen member: its vertex fits and SSE.  The refit
        // trades arithmetic for registers; the function needs none of it
        // (the family loop computed the same values), so the tally for the
        // bound leaves it out.
        if constexpr (C::GLOBAL) {
          res.k = fam_vm.member(chosen, res.vp);
        } else {
          res.k = bit_positions(fam_vm[chosen], res.vp);
        }
        NoOps refit_ops;
        const T sse_c = fit_model<true, C>(s, res.vp, res.k, y_range, p, res.vf, mem, refit_ops);
        ops.add(10LL * ny + 4LL * p.nm + 2);
        res.mv = true;
        res.rmse = f_sqrt(sse_c / n_safe);
        res.pof = p_c;
        return;
      }
    }
  }
  // flat no-fit model: the mean of the (despiked when enough) valid series
  T sum_y = 0;
  for (int i = 0; i < n; ++i) sum_y = sum_y + s.y(i);
  const bool has_any = n > 0;
  const T mean = has_any ? sum_y / n_safe : (T)0;
  T ssr = 0;
  for (int i = 0; i < n; ++i) {
    T r = s.y(i) - mean;
    ssr = ssr + r * r;
  }
  res.k = 0;
  res.mean = mean;
  res.rmse = has_any ? f_sqrt(ssr / n_safe) : (T)0;
  res.pof = 1;
  ops.add(5LL * n + 2);
}

// Store one pixel-major field of the block's rows: each live thread fills
// its row of `w` values in the staging tile (row stride w | 1, odd, so the
// lanes of a warp write 32 different banks), then the block copies the
// tile to `dst` (the block's first row) in coalesced runs.  Every thread of
// the block must call it.
template <typename U, int B, class F>
__device__ __forceinline__ void emit(U* __restrict__ dst, int w, int npx, void* stage, bool live,
                                     const F& fill) {
  const int nb = nthreads<B>();
  U* st = reinterpret_cast<U*>(stage);
  const int W = w | 1;
  if (live) fill(st + threadIdx.x * W);
  __syncthreads();
  const int total = npx * w;
  int row = threadIdx.x / w, col = threadIdx.x - row * w;
  const int dr = nb / w, dc = nb - dr * w;
  for (int e = threadIdx.x; e < total; e += nb) {
    dst[e] = st[row * W + col];
    row += dr;
    col += dc;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
  __syncthreads();
}

// One row's trajectory over every year: np.interp through `nv` vertex
// slots of which the first k (>= 1) are live, at years xv(i) with fits
// vf[i]; dead slots repeat (t_hi, the last fit), so xv(i) is t_hi for
// i >= k.  The year axis ascends, so the slots at or below each year are
// counted by a forward walk.
template <typename T, class X, class F>
__device__ __forceinline__ void interp_row(T* row, const T* ts, int ny, int nv, int k, T t_hi,
                                           const X& xv, const F& vf) {
  const T eps_g = ulp_of_eps<T>();
  const T x0 = xv(0), f0 = vf[0];
  const T xlast = k == nv ? xv(k - 1) : t_hi;
  const T flast = vf[k - 1];
  int ci = 0;  // vertex slots with xp <= year, walked forward
  for (int j = 0; j < ny; ++j) {
    const T tj = ts[j];
    while (ci < nv && xv(ci) <= tj) ++ci;
    const int i = ci < 1 ? 1 : (ci > nv - 1 ? nv - 1 : ci);
    const T xp_i = xv(i);
    const T xp_im1 = xv(i - 1);
    const T fp_i = i < k ? vf[i] : flast;
    const T fp_im1 = i - 1 < k ? vf[i - 1] : flast;
    const T df = fp_i - fp_im1;
    const T dx = xp_i - xp_im1;
    const T delta = tj - xp_im1;
    T f = f_abs(dx) <= eps_g ? fp_im1 : fp_im1 + (delta / dx) * df;
    if (tj < x0) f = f0;
    if (tj > xlast) f = flast;
    row[j] = f;
  }
}

template <typename T, class O, int B, class C>
__global__ void __launch_bounds__(B > 0 ? B : GLOBAL_MAX_BLOCK)
segment_fused_kernel(const T* __restrict__ years, const T* __restrict__ values,
                     const uint8_t* __restrict__ mask, long long px, int ny, Outs<T> o,
                     Params p, long long* __restrict__ stats, unsigned char* scratch) {
  O ops;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = nthreads<B>();
  // the block's memory: its shared memory, or its region of the scratch
  // tier (chosen here, not in a helper: the fixed forms' code must stay
  // as it was, bit for bit and register for register)
  unsigned char* bmem = smem;
  if constexpr (C::SCRATCH) {
    bmem = scratch +
           (long long)blockIdx.x * global_region_bytes(ny, p.nc, p.nm, (int)sizeof(T), nb);
  }
  const Block<T, B> blk(bmem, ny);
  const long long base = (long long)blockIdx.x * nb;
  const int npx = (int)(px - base < nb ? px - base : nb);
  const int r = threadIdx.x;
  const bool live = r < npx;
  const Mem<T, C> mem(bmem, ny, nb, p);
  const typename Store<C>::Set valid =
      load_compact<T, B, C>(blk, years, values + base * ny, mask + base * ny, npx, ny);
  Series<T, B> s{blk.ycol + r, blk.region + r, valid.count(), nb};
  const int n = s.n;
  ops.mark(LOAD);

  PixelResult<T, C> res;
  res.bind(mem);
  res.mv = false;
  res.k = 0;
  if (live) segment_pixel(s, ny, p, res, mem, ops);

  // ---- output: every thread, one staged field at a time ----------------
  __syncthreads();  // every t column is read: the region becomes the staging tile
  void* stage = blk.region;
  const T* ts = blk.ts;
  const int k = res.k;
  typename Store<C>::template Arr<int> vyi;  // year index of each vertex
  if constexpr (C::SCRATCH) vyi = mem.template arr<int>(P_VYI);
  for (int j = 0; j < k; ++j) vyi[j] = nth_bit(valid, res.vp[j]);
  const T t_hi = n > 0 ? ts[valid.highest()] : (T)0;
  // vertex slot i's year; dead slots repeat t_hi
  auto xv = [&](int i) { return i < k ? ts[vyi[i]] : t_hi; };

  // despiked: the despiked series at valid years; elsewhere the raw value
  // (a fitted model) or the mean (the flat model)
  emit<T, B>(o.despiked + base * ny, ny, npx, stage, live, [&](T* row) {
    for (int j = 0, c = 0, d = 0; j < ny; ++j) {
      if (valid.test(j)) {
        row[j] = s.y(c++);
      } else {
        row[j] = res.mv ? s.y(n + d) : res.mean;
        ++d;
      }
    }
  });
  // fitted trajectory over every year: np.interp through the vertices,
  // dead slots repeating (t_hi, last fit); the mean for the flat model
  emit<T, B>(o.fitted + base * ny, ny, npx, stage, live, [&](T* row) {
    if (!res.mv) {
      for (int j = 0; j < ny; ++j) row[j] = res.mean;
      return;
    }
    interp_row(row, ts, ny, p.nv, k, t_hi, xv, res.vf);
  });
  const int nv = p.nv, nm = p.nm;
  emit<int32_t, B>(o.vidx + base * nv, nv, npx, stage, live, [&](int32_t* row) {
    for (int j = 0; j < nv; ++j) row[j] = j < k ? (int32_t)vyi[j] : -1;
  });
  emit<T, B>(o.vyear + base * nv, nv, npx, stage, live, [&](T* row) {
    for (int j = 0; j < nv; ++j) row[j] = j < k ? ts[vyi[j]] : (T)0;
  });
  emit<T, B>(o.vsrc + base * nv, nv, npx, stage, live, [&](T* row) {
    for (int j = 0; j < nv; ++j) row[j] = j < k ? s.y(res.vp[j]) : (T)0;
  });
  emit<T, B>(o.vfit + base * nv, nv, npx, stage, live, [&](T* row) {
    for (int j = 0; j < nv; ++j) row[j] = j < k ? res.vf[j] : (T)0;
  });
  emit<T, B>(o.smag + base * nm, nm, npx, stage, live, [&](T* row) {
    for (int j = 0; j < nm; ++j) row[j] = j < k - 1 ? res.vf[j + 1] - res.vf[j] : (T)0;
  });
  emit<T, B>(o.sdur + base * nm, nm, npx, stage, live, [&](T* row) {
    for (int j = 0; j < nm; ++j) row[j] = j < k - 1 ? xv(j + 1) - xv(j) : (T)0;
  });
  emit<T, B>(o.srate + base * nm, nm, npx, stage, live, [&](T* row) {
    for (int j = 0; j < nm; ++j) {
      T rate = 0;
      if (j < k - 1) {
        const T mag = res.vf[j + 1] - res.vf[j];
        const T dur = xv(j + 1) - xv(j);
        rate = dur > (T)0 ? mag / dur : (T)0;
      }
      row[j] = rate;
    }
  });
  if (live) {
    const long long pix = base + r;
    o.n_vertices[pix] = k;
    o.rmse[pix] = res.rmse;
    o.pof[pix] = res.pof;
    o.mv[pix] = res.mv ? 1 : 0;
    ops.mark(OUTPUT);
    if (stats != nullptr) ops.write(stats, pix);
  }
}

template <typename T>
struct FamilyOuts {
  T* despiked;       // (NY, ld)
  uint8_t* vmasks;   // (NM * NY, ld): row m * NY + j is member m's year j
  T* sses;           // (NM, ld)
  long long ld;
};

// Stages 1-4a for every pixel: despiked series, family vertex sets, SSEs.
template <typename T, class O, int B, class C>
__global__ void __launch_bounds__(B > 0 ? B : GLOBAL_MAX_BLOCK)
family_stats_kernel(const T* __restrict__ years, const T* __restrict__ values,
                    const uint8_t* __restrict__ mask, long long px, int ny, FamilyOuts<T> o,
                    Params p, long long* __restrict__ stats, unsigned char* scratch) {
  O ops;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = nthreads<B>();
  unsigned char* bmem = smem;  // as in segment_fused_kernel
  if constexpr (C::SCRATCH) {
    bmem = scratch +
           (long long)blockIdx.x * global_region_bytes(ny, p.nc, p.nm, (int)sizeof(T), nb);
  }
  const Block<T, B> blk(bmem, ny);
  const long long base = (long long)blockIdx.x * nb;
  const int npx = (int)(px - base < nb ? px - base : nb);
  const Mem<T, C> mem(bmem, ny, nb, p);
  const typename Store<C>::Set valid =
      load_compact<T, B, C>(blk, years, values + base * ny, mask + base * ny, npx, ny);
  const int r = threadIdx.x;
  Series<T, B> s{blk.ycol + r, blk.region + r, valid.count(), nb};
  if (r >= npx) return;
  const long long pix = base + threadIdx.x;
  const long long ld = o.ld;
  const int n = s.n;

  // Stage 1 — despike (a no-op below three valid years)
  despike(s, p, ops);
  T y_range = 0;
  Verts<T, C> v;
  v.bind(mem);
  v.k = 0;
  v.t_lo = 0;
  v.t_rng = 1;
  v.y_lo = 0;
  v.y_rng = 1;
  if (n > 0) {
    ops.add(2LL * n + 2);
    T y_hi = s.y(0);
    v.y_lo = s.y(0);
    for (int i = 1; i < n; ++i) {
      v.y_lo = t_min(v.y_lo, s.y(i));
      y_hi = t_max(y_hi, s.y(i));
    }
    y_range = t_max(y_hi - v.y_lo, (T)0);
    v.t_lo = s.t(0);
    const T t_hi = s.t(n - 1);
    v.t_rng = t_hi > v.t_lo ? t_hi - v.t_lo : (T)1;
    v.y_rng = y_hi > v.y_lo ? y_hi - v.y_lo : (T)1;
    v.vp[0] = 0;
    v.vp[1] = n - 1;
    v.k = n > 1 ? 2 : 1;  // one vertex when n == 1
  }
  // Stage 2 — candidates + angle cull (both no-ops on fewer than 3 vertices)
  find_candidates(s, v, p, ops);
  cull_init(s, v, ops);
  for (int q = 0; q < p.overshoot; ++q) remove_weakest(s, v, p.nv, ops);
  // Stage 4a — model family, written member by member
  for (int m = 0; m < p.nm; ++m) {
    // the member's vertex set on the year axis
    if constexpr (C::GLOBAL) {
      // the valid years walked once beside the member's ascending positions
      uint8_t* row = o.vmasks + (long long)m * ny * ld + pix;
      for (int j = 0, c = 0, i = 0; j < ny; ++j) {
        bool on = false;
        if (valid.test(j)) {
          on = i < v.k && v.vp[i] == c;
          i += on;
          ++c;
        }
        row[j * ld] = (uint8_t)on;
      }
    } else {
      typename Store<C>::Set year_word;
      year_word.clear();
      for (int j = 0; j < v.k; ++j) year_word.set(nth_bit(valid, v.vp[j]));
      uint8_t* row = o.vmasks + (long long)m * ny * ld + pix;
      for (int j = 0; j < ny; ++j) row[j * ld] = (uint8_t)year_word.test(j);
    }
    // below two vertices (fewer than two valid years) the fit is the
    // series itself: SSE 0, as in the plain version
    T* const no_vf = nullptr;
    const T sse = v.k >= 2 ? fit_model<false, C>(s, v.vp, v.k, y_range, p, no_vf, mem, ops) : (T)0;
    o.sses[m * ld + pix] = sse;
    if (m + 1 < p.nm) remove_weakest(s, v, 2, ops);
  }
  for (int j = 0, c = 0; j < ny; ++j) {
    o.despiked[j * ld + pix] = valid.test(j) ? s.y(c++) : (T)0;
  }
  if (stats != nullptr) ops.write(stats, pix);
}

// FTV: fit a target index's (PX, NY) series to each pixel's vertex years
// from the segmentation (`vidx`, (PX, NV) stack-axis indices, the first
// `nvert` live) and write the (PX, NY) trajectory.  The plain version is
// ops/ftv.py:torch_fit_to_vertices.  The global form's block, at NV in
// place of the candidates (p.nc = p.nv): the target's slab load and
// compaction, the anchored fit of the chosen model's refit and the
// fitted trajectory's interpolation are the fused kernel's.  The vertex
// set lives in vp, ascending: a vertex maps to the count of valid years
// before it (the nearest valid year at or after it), clipped to the last;
// one already in the set merges; fewer than two fall back to the first
// and last valid years.  A pixel with fewer than two vertices or two
// valid years gets the mean of its valid target values.
template <typename T, class C>
__global__ void __launch_bounds__(GLOBAL_MAX_BLOCK)
ftv_fit_kernel(const T* __restrict__ years, const T* __restrict__ values,
               const uint8_t* __restrict__ mask, const int32_t* __restrict__ vidx,
               const int32_t* __restrict__ nvert, T* __restrict__ out, long long px, int ny,
               Params p, unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = nthreads<0>();
  unsigned char* bmem = smem;  // as in segment_fused_kernel
  if constexpr (C::SCRATCH) {
    bmem = scratch +
           (long long)blockIdx.x * global_region_bytes(ny, p.nc, p.nm, (int)sizeof(T), nb);
  }
  const Block<T, 0> blk(bmem, ny);
  const long long base = (long long)blockIdx.x * nb;
  const int npx = (int)(px - base < nb ? px - base : nb);
  const int r = threadIdx.x;
  const bool live = r < npx;
  const Mem<T, C> mem(bmem, ny, nb, p);
  const GBits valid =
      load_compact<T, 0, C>(blk, years, values + base * ny, mask + base * ny, npx, ny);
  const Series<T, 0> s{blk.ycol + r, blk.region + r, valid.count(), nb};
  const int n = s.n;

  typename Store<C>::template Arr<int> vp, vyi;  // vertex positions, their year indices
  typename Store<C>::template Arr<T> vf;         // the fit at each vertex
  if constexpr (C::SCRATCH) {
    vp = mem.template arr<int>(P_RVP);
    vyi = mem.template arr<int>(P_VYI);
    vf = mem.template arr<T>(P_RVF);
  }
  int k = 0;  // live vertices; 0: the flat mean
  T mean = 0;
  if (live) {
    const long long pix = base + r;
    const int nverts = nvert[pix];
    if (n >= 2 && nverts >= 2) {
      const int32_t* row = vidx + pix * p.nv;
      const int slots = nverts < p.nv ? nverts : p.nv;
      for (int q = 0; q < slots; ++q) {
        const int yi = row[q];
        int pos = yi <= 0 ? 0 : (yi >= ny ? n : valid.count_below(yi));
        if (pos > n - 1) pos = n - 1;
        int at = k;
        while (at > 0 && vp[at - 1] > pos) --at;
        if (at > 0 && vp[at - 1] == pos) continue;
        for (int j = k; j > at; --j) vp[j] = vp[j - 1];
        vp[at] = pos;
        ++k;
      }
      if (k < 2) {
        vp[0] = 0;
        vp[1] = n - 1;
        k = 2;
      }
      // the range of the raw series (no despike)
      T y_lo = s.y(0), y_hi = s.y(0);
      for (int i = 1; i < n; ++i) {
        y_lo = t_min(y_lo, s.y(i));
        y_hi = t_max(y_hi, s.y(i));
      }
      NoOps ops;
      fit_model<true, C>(s, vp, k, t_max(y_hi - y_lo, (T)0), p, vf, mem, ops);
      for (int j = 0; j < k; ++j) vyi[j] = nth_bit(valid, vp[j]);
    } else {
      T sum_y = 0;
      for (int i = 0; i < n; ++i) sum_y = sum_y + s.y(i);
      mean = n > 0 ? sum_y / (T)n : (T)0;
    }
  }
  __syncthreads();  // every t column is read: the region becomes the staging tile
  const T* ts = blk.ts;
  const T t_hi = n > 0 ? ts[valid.highest()] : (T)0;
  auto xv = [&](int i) { return i < k ? ts[vyi[i]] : t_hi; };
  emit<T, 0>(out + base * ny, ny, npx, blk.region, live, [&](T* row) {
    if (k == 0) {
      for (int j = 0; j < ny; ++j) row[j] = mean;
      return;
    }
    interp_row(row, ts, ny, p.nv, k, t_hi, xv, vf);
  });
}

Params make_params(int max_segments, int overshoot, double spike, double rt, int prevent,
                   double pval, double bmp, int min_obs, int lentz_iters) {
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
  return p;
}

template <class C>
bool bad_shape(int ny, const Params& p, long long px) {
  return ny < 1 || ny > C::NY || p.nc > C::NC || p.nm < 1 || p.overshoot < 0 || px < 0;
}

// Whether `block` is a block the launch of capacity C may take: its own
// for a fixed capacity, 32, 64 or 128 threads for the global form.
template <class C>
bool block_ok(int block, int own) {
  if constexpr (C::GLOBAL) return block == 32 || block == 64 || block == GLOBAL_MAX_BLOCK;
  return block == own;
}

// Dynamic shared-memory bytes of one launch of capacity C at `nc`
// candidates (the global form's scratch tier uses none).
template <class C>
long long smem_of(int ny, int nc, int elem, int block) {
  if constexpr (C::SCRATCH) return 0;
  if constexpr (C::GLOBAL) return global_smem_bytes(ny, nc, elem, block);
  return smem_bytes(ny, elem, block, C::NC);
}

// Raise the kernel's dynamic shared-memory ceiling to `bytes`.
template <class K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <class K, class... A>
int start(K kernel, long long px, int block, long long bytes, cudaStream_t st, A... args) {
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  if (px == 0) return 0;
  const long long grid = (px + block - 1) / block;
  kernel<<<(unsigned)grid, block, (size_t)bytes, st>>>(args...);
  return (int)cudaGetLastError();
}

// One launch of the fused kernel of capacity C with policy O at block
// size B (O's per-pixel record, if any, goes to `stats`); the global
// form (B = 0) runs `block` threads a block.  `scratch`: the scratch
// tier's allocation, global_region_bytes per block; null otherwise.
template <typename T, class O, class C = Narrow, int B = block_of<T, C>()>
int launch_fused(const void* years, const void* values, const void* mask, long long px, int ny,
                 const Outs<T>& o, const Params& p, void* stream, long long* stats,
                 void* scratch = nullptr, int block = B) {
  if (bad_shape<C>(ny, p, px) || (C::SCRATCH && scratch == nullptr) || !block_ok<C>(block, B)) {
    return (int)cudaErrorInvalidValue;
  }
  return start(segment_fused_kernel<T, O, B, C>, px, block,
               smem_of<C>(ny, p.nc, (int)sizeof(T), block), (cudaStream_t)stream,
               (const T*)years, (const T*)values, (const uint8_t*)mask, px, ny, o, p, stats,
               (unsigned char*)scratch);
}

template <typename T, class O, class C = Narrow>
int launch_family(const void* years, const void* values, const void* mask, long long px, int ny,
                  const FamilyOuts<T>& o, const Params& p, void* stream, long long* stats,
                  void* scratch = nullptr, int block = block_of<T, C>()) {
  constexpr int B = block_of<T, C>();
  if (bad_shape<C>(ny, p, px) || (C::SCRATCH && scratch == nullptr) || !block_ok<C>(block, B)) {
    return (int)cudaErrorInvalidValue;
  }
  return start(family_stats_kernel<T, O, B, C>, px, block,
               smem_of<C>(ny, p.nc, (int)sizeof(T), block), (cudaStream_t)stream,
               (const T*)years, (const T*)values, (const uint8_t*)mask, px, ny, o, p, stats,
               (unsigned char*)scratch);
}

// One launch of the FTV kernel in the global form's shared tier (GShared)
// or its scratch tier (GScratch), `block` threads a block.
template <typename T, class C>
int launch_ftv(const void* years, const void* values, const void* mask, const void* vidx,
               const void* nvert, void* out, long long px, int ny, const Params& p, void* stream,
               void* scratch, int block) {
  if (bad_shape<C>(ny, p, px) || (C::SCRATCH && scratch == nullptr) || !block_ok<C>(block, 0)) {
    return (int)cudaErrorInvalidValue;
  }
  return start(ftv_fit_kernel<T, C>, px, block, smem_of<C>(ny, p.nc, (int)sizeof(T), block),
               (cudaStream_t)stream, (const T*)years, (const T*)values, (const uint8_t*)mask,
               (const int32_t*)vidx, (const int32_t*)nvert, (T*)out, px, ny, p,
               (unsigned char*)scratch);
}

// ---------------------------------------------------------------------------
// The tile program's index kernel: DNs and QA to the mask and the indices.
//
// What bounds it: bytes.  An element (a pixel-year) reads 2 B of each
// shipped band and of QA and writes 1 B of mask and 4 B an index, with no
// reuse and a handful of operations: NBR alone on a 1024² x 40 tile moves
// 462 MB, 0.14 ms at 3.35 TB/s.  The design streams each band once.  A
// thread takes IDX_VEC = 8 consecutive elements of the flat (PX * NY)
// layout: one 16-byte load of each band and of QA, the scaled values kept in
// registers, each index written as two 16-byte stores straight into its
// destination (a row block of the caller's series or FTV buffer), the mask
// as one 8-byte store.  A grid-stride loop at the blocks an SM holds walks
// the tile; the ragged end, or a launch whose pointers are off that
// alignment (`vec` = 0, the wrapper's check), goes element by element.  The
// outputs are a runtime table passed by value, each described as data: a
// normalized difference by its two band slots, a weighted band sum (the
// tasseled caps) by its coefficients, then its sign and its destination.
// So the kernel knows no index by name, and one instantiation per DN and QA
// type serves every combination of primary, ensemble and FTV indices.
//
// The same bits as the plain version, rounded at the same places: the DN
// widened to float, times the scale, plus the offset, each step rounded on
// its own; the mask is the QA test (the word widened to int32 as its type
// reads it) AND, for every shipped band, isfinite & >= 0 & <= 1 of its
// scaled value; a normalized difference is (a - b) / (a + b), IEEE
// division, 0 where a + b is 0; a tasseled cap is summed left to right in
// band order, each c * b rounded before the add; the sign multiply comes
// last.  The card's round-to-nearest intrinsics keep every step apart
// whatever the compiler would contract.

// Band slots, in ops/indices.py:BANDS order.
constexpr int IDX_BANDS = 6;
// Outputs one launch writes at most; elements a thread takes at once;
// threads a block.
constexpr int IDX_MAX_OUT = 16;
constexpr int IDX_VEC = 8;
constexpr int IDX_BLOCK = 256;

// (slot a - slot b) / (slot a + slot b) where a >= 0; else the sum of
// coef[s] * slot s in band order.
struct IndexOut {
  int a, b;
  float sign;
  float coef[IDX_BANDS];
  float* dst;
};

struct IndexTable {
  const void* band[IDX_BANDS];  // null: the band is not shipped
  const void* qa;
  uint8_t* mask;
  long long n;  // elements of each plane
  float scale, offset;
  int reject;
  int n_out;
  IndexOut out[IDX_MAX_OUT];
};

// N values of T in one aligned access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Float arithmetic rounded step by step (the card's intrinsics; the plain
// operators where the source is compiled for the host).
__device__ __forceinline__ float f_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
__device__ __forceinline__ float f_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
__device__ __forceinline__ float f_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
__device__ __forceinline__ float f_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

// ops/indices.py:_safe_ratio of (a - b, a + b).
__device__ __forceinline__ float normalized_difference(float a, float b) {
  const float den = f_add(a, b);
  return den != 0.0f ? f_div(f_sub(a, b), den) : 0.0f;
}

// Band slot `s` of element e, picked by selects so that `v` stays in
// registers (a runtime index into it would put it in local memory).
template <int N>
__device__ __forceinline__ float band_slot(const float (&v)[IDX_BANDS][N], int s, int e) {
  float x = 0.0f;
#pragma unroll
  for (int k = 0; k < IDX_BANDS; ++k) x = k == s ? v[k][e] : x;
  return x;
}

template <int N>
__device__ __forceinline__ float index_value(const IndexOut& o, const float (&v)[IDX_BANDS][N],
                                             int e) {
  if (o.a >= 0) return normalized_difference(band_slot<N>(v, o.a, e), band_slot<N>(v, o.b, e));
  float acc = f_mul(o.coef[0], v[0][e]);
#pragma unroll
  for (int s = 1; s < IDX_BANDS; ++s) acc = f_add(acc, f_mul(o.coef[s], v[s][e]));
  return acc;
}

// Elements i .. i + N - 1: N = IDX_VEC on aligned pointers, 1 otherwise.
template <int N, typename D, typename Q>
__device__ __forceinline__ void index_elements(const IndexTable& t, long long i) {
  float v[IDX_BANDS][N] = {};
  bool ok[N];
  const Vec<Q, N> q = *reinterpret_cast<const Vec<Q, N>*>((const Q*)t.qa + i);
#pragma unroll
  for (int e = 0; e < N; ++e) ok[e] = ((int)q.v[e] & t.reject) == 0;
#pragma unroll
  for (int s = 0; s < IDX_BANDS; ++s) {
    if (t.band[s] == nullptr) continue;
    const Vec<D, N> d = *reinterpret_cast<const Vec<D, N>*>((const D*)t.band[s] + i);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float x = f_add(f_mul((float)d.v[e], t.scale), t.offset);
      v[s][e] = x;
      ok[e] = ok[e] & (isfinite(x) && x >= 0.0f && x <= 1.0f);
    }
  }
  Vec<uint8_t, N> m;
#pragma unroll
  for (int e = 0; e < N; ++e) m.v[e] = ok[e];
  *reinterpret_cast<Vec<uint8_t, N>*>(t.mask + i) = m;
#pragma unroll
  for (int j = 0; j < IDX_MAX_OUT; ++j) {
    if (j < t.n_out) {
      const IndexOut& o = t.out[j];
      constexpr int W = N < 4 ? N : 4;  // floats a store
#pragma unroll
      for (int h = 0; h < N; h += W) {
        Vec<float, W> r;
#pragma unroll
        for (int e = 0; e < W; ++e) r.v[e] = f_mul(o.sign, index_value<N>(o, v, h + e));
        *reinterpret_cast<Vec<float, W>*>(o.dst + i + h) = r;
      }
    }
  }
}

// `stride`: the launch's threads (grid x IDX_BLOCK).
template <typename D, typename Q>
__global__ void __launch_bounds__(IDX_BLOCK)
tile_index_kernel(const IndexTable t, int vec, long long stride) {
  const long long tid = (long long)blockIdx.x * IDX_BLOCK + threadIdx.x;
  const long long groups = vec ? t.n / IDX_VEC : 0;
  for (long long g = tid; g < groups; g += stride) {
    index_elements<IDX_VEC, D, Q>(t, g * IDX_VEC);
  }
  for (long long i = groups * IDX_VEC + tid; i < t.n; i += stride) {
    index_elements<1, D, Q>(t, i);
  }
}

// One launch at the grid the card holds at once (its `sms` SMs times the
// kernel's resident blocks an SM), or fewer where the tile needs fewer.
template <typename D, typename Q>
int launch_index(const IndexTable& t, int vec, int sms, void* stream) {
  const auto kernel = tile_index_kernel<D, Q>;
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                       IDX_BLOCK, 0);
  if (e != cudaSuccess) return (int)e;
  const long long work = vec ? t.n / IDX_VEC + t.n % IDX_VEC : t.n;
  long long grid = (work + IDX_BLOCK - 1) / IDX_BLOCK;
  const long long held = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > held) grid = held;
  return start(kernel, grid * IDX_BLOCK, IDX_BLOCK, 0, (cudaStream_t)stream, t, vec,
               grid * IDX_BLOCK);
}

// Resident blocks per SM of `kernel` as the production launch sets it up
// (its dynamic shared memory).
template <class K>
int occupancy(K kernel, int block, long long bytes, int* blocks) {
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, block, (size_t)bytes);
}

// The block sizes of the float32 fused kernel's block-size sweep: calls
// f(std::integral_constant<int, block>) for one of them.
template <class F>
int with_sweep_block(int block, F f) {
  switch (block) {
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
    case 512: return f(std::integral_constant<int, 512>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers and local bytes (cudaFuncGetAttributes) of `kernel`: out =
// {numRegs, localSizeBytes, sharedSizeBytes (static), maxThreadsPerBlock}.
template <class K>
int attrs_of(K kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kernel));
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return 0;
}

// Resident blocks per SM (CUDA occupancy calculator) of a production
// kernel of capacity C at `ny` years, `nc` candidates and block `block`
// (a fixed capacity's own): which = 0 fused, 1 family.  Returns a CUDA
// error code.
template <class C>
int occupancy_of(int which, int f64, int ny, int nc, int block, int* blocks) {
  constexpr int B4 = block_of<float, C>(), B8 = block_of<double, C>();
  if (!block_ok<C>(block, f64 ? B8 : B4)) return (int)cudaErrorInvalidValue;
  const long long b4 = smem_of<C>(ny, nc, 4, block), b8 = smem_of<C>(ny, nc, 8, block);
  if (which == 0) {
    return f64 ? occupancy(segment_fused_kernel<double, NoOps, B8, C>, block, b8, blocks)
               : occupancy(segment_fused_kernel<float, NoOps, B4, C>, block, b4, blocks);
  }
  return f64 ? occupancy(family_stats_kernel<double, NoOps, B8, C>, block, b8, blocks)
             : occupancy(family_stats_kernel<float, NoOps, B4, C>, block, b4, blocks);
}

// cudaFuncGetAttributes of a production kernel of capacity C: which = 0
// fused, 1 family.
template <class C>
int attrs_of_cap(int which, int f64, int* out) {
  constexpr int B4 = block_of<float, C>(), B8 = block_of<double, C>();
  if (which == 0) {
    return f64 ? attrs_of(segment_fused_kernel<double, NoOps, B8, C>, out)
               : attrs_of(segment_fused_kernel<float, NoOps, B4, C>, out);
  }
  return f64 ? attrs_of(family_stats_kernel<double, NoOps, B8, C>, out)
             : attrs_of(family_stats_kernel<float, NoOps, B4, C>, out);
}

template <typename T>
Outs<T> make_outs(void* despiked, void* fitted, void* n_vertices, void* vidx, void* vyear,
                  void* vsrc, void* vfit, void* smag, void* sdur, void* srate, void* rmse,
                  void* pof, void* mv) {
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
  return o;
}

template <typename T>
FamilyOuts<T> make_family_outs(void* despiked, void* vmasks, void* sses, long long out_ld) {
  FamilyOuts<T> o;
  o.despiked = (T*)despiked;
  o.vmasks = (uint8_t*)vmasks;
  o.sses = (T*)sses;
  o.ld = out_ld;
  return o;
}

}  // namespace

#define LT_ARGS                                                                               \
  const void *years, const void *values, const void *mask, long long px, int ny,             \
      void *despiked, void *fitted, void *n_vertices, void *vidx, void *vyear, void *vsrc,   \
      void *vfit, void *smag, void *sdur, void *srate, void *rmse, void *pof, void *mv,      \
      int max_segments, int overshoot, double spike, double rt, int prevent, double pval,    \
      double bmp, int min_obs, int lentz_iters, void *stream
#define LT_PARAMS \
  make_params(max_segments, overshoot, spike, rt, prevent, pval, bmp, min_obs, lentz_iters)
#define LT_OUTS \
  despiked, fitted, n_vertices, vidx, vyear, vsrc, vfit, smag, sdur, srate, rmse, pof, mv
#define LT_CALL(T) \
  years, values, mask, px, ny, make_outs<T>(LT_OUTS), LT_PARAMS, stream

extern "C" {

// The library is built from two objects of this file compiled at once:
// LT_PART 1 holds the fixed forms' entries, 2 the global form's (without
// LT_PART, both).
#if !defined(LT_PART) || LT_PART == 1

// Capacity bounds the Python wrapper checks before a launch, one query
// per fixed instantiation (narrow, wide); the global form has none.
int lt_segment_max_ny() { return Narrow::NY; }
int lt_segment_max_nc() { return Narrow::NC; }
int lt_segment_block(int elem_bytes) {
  return elem_bytes == 4 ? block_of<float>() : block_of<double>();
}
int lt_segment_wide_max_ny() { return Wide::NY; }
int lt_segment_wide_max_nc() { return Wide::NC; }
int lt_segment_wide_block(int elem_bytes) {
  return elem_bytes == 4 ? block_of<float, Wide>() : block_of<double, Wide>();
}
int lt_segment_nstage() { return NSTAGE; }

// Dynamic shared-memory bytes of one block of `block` threads at `ny`
// years and `elem_bytes`-byte values of the narrow (cap = 0) or wide (1)
// instantiation (both kernels use the same plan).
long long lt_segment_smem_bytes(int ny, int elem_bytes, int block, int cap) {
  return smem_bytes(ny, elem_bytes, block, cap ? Wide::NC : Narrow::NC);
}

int lt_segment_fused_f32(LT_ARGS) { return launch_fused<float, NoOps>(LT_CALL(float), nullptr); }
int lt_segment_fused_f64(LT_ARGS) { return launch_fused<double, NoOps>(LT_CALL(double), nullptr); }
int lt_segment_fused_wide_f32(LT_ARGS) {
  return launch_fused<float, NoOps, Wide>(LT_CALL(float), nullptr);
}
int lt_segment_fused_wide_f64(LT_ARGS) {
  return launch_fused<double, NoOps, Wide>(LT_CALL(double), nullptr);
}

// The float32 kernel with its per-pixel operation tally written to
// `op_count` (PX int64) — the roofline bound's operation count.
int lt_segment_fused_f32_opcount(LT_ARGS, void *op_count) {
  return launch_fused<float, CountOps>(LT_CALL(float), (long long *)op_count);
}
int lt_segment_fused_wide_f32_opcount(LT_ARGS, void *op_count) {
  return launch_fused<float, CountOps, Wide>(LT_CALL(float), (long long *)op_count);
}

// The float32 kernel with each pixel's clock64() cycles per stage and
// their total written to `cycles` (PX x (NSTAGE + 1) int64, row-major).
int lt_segment_fused_f32_stagecycles(LT_ARGS, void *cycles) {
  return launch_fused<float, StageCycles>(LT_CALL(float), (long long *)cycles);
}

// The float32 kernel at a block size of the sweep (128, 256 or 512
// threads).  (The global form's sweep is its own entry at another block.)
int lt_segment_fused_f32_block(LT_ARGS, int block) {
  return with_sweep_block(block, [&](auto b) {
    return launch_fused<float, NoOps, Narrow, decltype(b)::value>(LT_CALL(float), nullptr);
  });
}

// As occupancy_of for the narrow (cap = 0) or wide (1) instantiation; the
// narrow float32 fused kernel also at the sweep's block sizes.
int lt_segment_occupancy(int which, int f64, int ny, int block, int cap, int *blocks) {
  if (cap == 1) return occupancy_of<Wide>(which, f64, ny, 0, block, blocks);
  if (which == 0 && !f64) {
    return with_sweep_block(block, [&](auto b) {
      constexpr int B = decltype(b)::value;
      return occupancy(segment_fused_kernel<float, NoOps, B, Narrow>, B,
                       smem_bytes(ny, 4, B, Narrow::NC), blocks);
    });
  }
  return occupancy_of<Narrow>(which, f64, ny, 0, block, blocks);
}

// cudaFuncGetAttributes of the production kernel `which` (0 fused, 1
// family) of the narrow (cap = 0) or wide (1) instantiation into out[4]:
// registers, local bytes, static shared bytes, max threads a block.
int lt_segment_kernel_attrs(int which, int f64, int cap, int *out) {
  if (cap == 1) return attrs_of_cap<Wide>(which, f64, out);
  return attrs_of_cap<Narrow>(which, f64, out);
}

#endif  // LT_PART 1
#if !defined(LT_PART) || LT_PART == 2

// The global form's plan (both kernels use it): the shared tier's block
// at `ny` years, `elem_bytes`-byte values and `nc` candidates (0: the
// scratch tier), its shared bytes at a block, the local arrays' capacity,
// and the scratch tier's bytes for `px` pixels (CUDA_BLOCK a block).
int lt_segment_global_block(int ny, int elem_bytes, int nc) {
  return global_block(ny, elem_bytes, nc);
}
long long lt_segment_global_smem_bytes(int ny, int nc, int elem_bytes, int block) {
  return global_smem_bytes(ny, nc, elem_bytes, block);
}
int lt_segment_global_local_nc() { return LOCAL_NC; }
long long lt_segment_global_scratch_bytes(int ny, int nc, int nm, int elem_bytes, long long px) {
  return (px + CUDA_BLOCK - 1) / CUDA_BLOCK *
         global_region_bytes(ny, nc, nm, elem_bytes, CUDA_BLOCK);
}

// The global form at `block` threads a block: the shared tier (tier = 0),
// or the scratch tier (1), whose `scratch` holds
// lt_segment_global_scratch_bytes(px) bytes.
int lt_segment_fused_global_f32(LT_ARGS, void *scratch, int block, int tier) {
  return tier ? launch_fused<float, NoOps, GScratch>(LT_CALL(float), nullptr, scratch, block)
              : launch_fused<float, NoOps, GShared>(LT_CALL(float), nullptr, nullptr, block);
}
int lt_segment_fused_global_f64(LT_ARGS, void *scratch, int block, int tier) {
  return tier ? launch_fused<double, NoOps, GScratch>(LT_CALL(double), nullptr, scratch, block)
              : launch_fused<double, NoOps, GShared>(LT_CALL(double), nullptr, nullptr, block);
}

// The global form's op tally, in either tier; its stage cycles are the
// shared tier's (tier = 0).
int lt_segment_fused_global_f32_opcount(LT_ARGS, void *scratch, int block, int tier,
                                        void *op_count) {
  return tier ? launch_fused<float, CountOps, GScratch>(LT_CALL(float), (long long *)op_count,
                                                        scratch, block)
              : launch_fused<float, CountOps, GShared>(LT_CALL(float), (long long *)op_count,
                                                       nullptr, block);
}
int lt_segment_fused_global_f32_stagecycles(LT_ARGS, void *scratch, int block, int tier,
                                            void *cycles) {
  if (tier || scratch) return (int)cudaErrorInvalidValue;
  return launch_fused<float, StageCycles, GShared>(LT_CALL(float), (long long *)cycles, nullptr,
                                                   block);
}

// As occupancy_of for the global form's shared tier at `nc` candidates and
// `block` threads.
int lt_segment_global_occupancy(int which, int f64, int ny, int nc, int block, int *blocks) {
  return occupancy_of<GShared>(which, f64, ny, nc, block, blocks);
}

// As lt_segment_kernel_attrs for the global form's shared (tier = 0) or
// scratch (1) tier.
int lt_segment_global_kernel_attrs(int which, int f64, int tier, int *out) {
  return tier ? attrs_of_cap<GScratch>(which, f64, out) : attrs_of_cap<GShared>(which, f64, out);
}

#endif  // LT_PART 2

#define LT_FAMILY_ARGS                                                                       \
  const void *years, const void *values, const void *mask, long long px, int ny,            \
      void *despiked, void *vmasks, void *sses, long long out_ld, int max_segments,          \
      int overshoot, double spike, double rt, int prevent, void *stream
#define LT_FAMILY(T, O, C, stats, scratch, block)                                             \
  launch_family<T, O, C>(years, values, mask, px, ny,                                        \
                      make_family_outs<T>(despiked, vmasks, sses, out_ld),                   \
                      make_params(max_segments, overshoot, spike, rt, prevent, 0.0, 1.0, 0, 0), \
                      stream, stats, scratch, block)
#if !defined(LT_PART) || LT_PART == 1

int lt_family_stats_f32(LT_FAMILY_ARGS) {
  return LT_FAMILY(float, NoOps, Narrow, nullptr, nullptr, (block_of<float, Narrow>()));
}
int lt_family_stats_f64(LT_FAMILY_ARGS) {
  return LT_FAMILY(double, NoOps, Narrow, nullptr, nullptr, (block_of<double, Narrow>()));
}
int lt_family_stats_wide_f32(LT_FAMILY_ARGS) {
  return LT_FAMILY(float, NoOps, Wide, nullptr, nullptr, (block_of<float, Wide>()));
}
int lt_family_stats_wide_f64(LT_FAMILY_ARGS) {
  return LT_FAMILY(double, NoOps, Wide, nullptr, nullptr, (block_of<double, Wide>()));
}

// The float32 family kernel with its per-pixel operation tally.
int lt_family_stats_f32_opcount(LT_FAMILY_ARGS, void *op_count) {
  return LT_FAMILY(float, CountOps, Narrow, (long long *)op_count, nullptr,
                   (block_of<float, Narrow>()));
}
int lt_family_stats_wide_f32_opcount(LT_FAMILY_ARGS, void *op_count) {
  return LT_FAMILY(float, CountOps, Wide, (long long *)op_count, nullptr,
                   (block_of<float, Wide>()));
}

#endif  // LT_PART 1
#if !defined(LT_PART) || LT_PART == 2

int lt_family_stats_global_f32(LT_FAMILY_ARGS, void *scratch, int block, int tier) {
  return tier ? LT_FAMILY(float, NoOps, GScratch, nullptr, scratch, block)
              : LT_FAMILY(float, NoOps, GShared, nullptr, nullptr, block);
}
int lt_family_stats_global_f64(LT_FAMILY_ARGS, void *scratch, int block, int tier) {
  return tier ? LT_FAMILY(double, NoOps, GScratch, nullptr, scratch, block)
              : LT_FAMILY(double, NoOps, GShared, nullptr, nullptr, block);
}
int lt_family_stats_global_f32_opcount(LT_FAMILY_ARGS, void *scratch, int block, int tier,
                                       void *op_count) {
  return tier ? LT_FAMILY(float, CountOps, GScratch, (long long *)op_count, scratch, block)
              : LT_FAMILY(float, CountOps, GShared, (long long *)op_count, nullptr, block);
}

#endif  // LT_PART 2

// The FTV kernel in the global form's shared tier (tier = 0) or its
// scratch tier (1).  The caller's plan (lt_segment_global_block and
// friends) sets `overshoot`, and so the candidate count the kernel's
// arrays and region layout are sized for; the launch takes it as given.
#define LT_FTV_ARGS                                                                           \
  const void *years, const void *values, const void *mask, const void *vidx, const void *nvert, \
      void *out, long long px, int ny, int max_segments, int overshoot, double rt, int prevent, \
      void *stream, void *scratch, int block, int tier
#define LT_FTV(T)                                                                             \
  (tier ? launch_ftv<T, GScratch> : launch_ftv<T, GShared>)(                                 \
      years, values, mask, vidx, nvert, out, px, ny,                                          \
      make_params(max_segments, overshoot, 0.0, rt, prevent, 0.0, 1.0, 0, 0), stream, scratch, \
      block)
#if !defined(LT_PART) || LT_PART == 1

int lt_ftv_fit_f32(LT_FTV_ARGS) { return LT_FTV(float); }
int lt_ftv_fit_f64(LT_FTV_ARGS) { return LT_FTV(double); }

// The index kernel: the outputs one launch writes at most.
int lt_tile_index_max_out() { return IDX_MAX_OUT; }

// One launch of the index kernel over `n` elements of each plane.  `bands`
// holds the six band pointers in band order (null: not shipped), all of one
// DN type; `dn_type` and `qa_type` are 0 for int16 and 1 for uint16.
// Output j is the normalized difference of band slots slots[2j] and
// slots[2j + 1], or where slots[2j] is -1 the sum of coefs[6j .. 6j + 5]
// times the bands, times signs[j], written to dsts[j]; the mask goes to
// `mask`.  `vec` = 1 takes 8
// elements a thread (every pointer 16-byte aligned, the mask 8-byte), 0 one.
// `sms`: the card's SMs, which size the grid.
int lt_tile_indices(const void *const *bands, const void *qa, void *mask, long long n,
                    int dn_type, int qa_type, double scale, double offset, int reject, int n_out,
                    const int *slots, const double *signs, const double *coefs,
                    void *const *dsts, int vec, int sms, void *stream) {
  if (n < 0 || n_out < 0 || n_out > IDX_MAX_OUT || sms < 1 || (dn_type | qa_type) & ~1) {
    return (int)cudaErrorInvalidValue;
  }
  IndexTable t = {};
  for (int s = 0; s < IDX_BANDS; ++s) t.band[s] = bands[s];
  t.qa = qa;
  t.mask = (uint8_t *)mask;
  t.n = n;
  t.scale = (float)scale;
  t.offset = (float)offset;
  t.reject = reject;
  t.n_out = n_out;
  for (int j = 0; j < n_out; ++j) {
    const int a = slots[2 * j], b = slots[2 * j + 1];
    if (a < -1 || a >= IDX_BANDS || (a >= 0 && (b < 0 || b >= IDX_BANDS))) {
      return (int)cudaErrorInvalidValue;
    }
    t.out[j].a = a;
    t.out[j].b = b;
    t.out[j].sign = (float)signs[j];
    for (int s = 0; s < IDX_BANDS; ++s) t.out[j].coef[s] = (float)coefs[j * IDX_BANDS + s];
    t.out[j].dst = (float *)dsts[j];
  }
  switch (dn_type * 2 + qa_type) {
    case 0: return launch_index<int16_t, int16_t>(t, vec, sms, stream);
    case 1: return launch_index<int16_t, uint16_t>(t, vec, sms, stream);
    case 2: return launch_index<uint16_t, int16_t>(t, vec, sms, stream);
    default: return launch_index<uint16_t, uint16_t>(t, vec, sms, stream);
  }
}

#endif  // LT_PART 1

}  // extern "C"
