// ADMM solver for small dense QPs on NVIDIA Hopper (sm_90a): one block of
// threads per problem, the whole solve in one launch.
//
// Replaces no Pallas kernel: the JAX package's solver
// (assistedmanipulation_tpu/ops/admm_qp.py::solve_qp) is plain jnp, and so
// is the port's plain version (ops/admm_qp.solve_qp_plain), which issues
// three device operations per ADMM iteration (a clamp, a batched product
// and a product-add) besides each block's factorisation, inverse and map
// assembly and the residual balancing: ~700 operations per solve of the
// safety filter's 12 x 37 QP at 4 blocks x 40 iterations, each a graph
// node of its own with its launch gap and its trip through device memory.
//
// The mathematics is the plain version's, step for step (OSQP, Stellato et
// al. 2020, with a fixed count of blocks and iterations and no
// data-dependent stop): the row equilibration scale_j = 1 / max(max_k
// |A_jk|, 1e-8); per block K = P + sigma I + rho A^T A, its Cholesky factor
// L (NaN throughout where K is not positive definite, as
// ops/linalg.cholesky_factor gives), L^-1 by forward substitution, K^-1 =
// L^-T L^-1 and E = [I; A] K^-1; the maps of the pair s = (x, w, 1),
// (x+, w+, 1) = T1 s + T2 z with z = clamp(w, l, u); `iterations` steps of
// that map; x, z = clamp(w, l, u) and y = rho (w - z); between blocks the
// residual-balanced rho (OSQP eq. 28, ratio clamped to [1e-3, 1e3], rho to
// [1e-6, 1e6]); the residuals max |A x - z| and max |P x + q + A^T y|; z and
// y returned in the caller's unscaled rows. Clamps and maxima propagate NaN
// as torch.clamp, torch.maximum and torch.amax do. IEEE sqrt and division
// (no --use_fast_math); products and sums contract to FMAs, and sums run
// in another order than cuBLAS's, so the kernel agrees with the plain
// version to rounding.
//
// What bounds it: the chain of dependent iterations, not arithmetic. An
// iteration at 12 x 37 is ~4,350 FMAs (the 50 x 87 map [T1 | T2] times the
// vector (s, z)), ~0.7 M a solve with the block set-ups: well under a
// microsecond of the card's FP32 rate. Its 160 iterations each wait for the
// last: a shared-memory read, the FMAs, a warp reduction and a barrier.
//
// Design. One block of threads per problem (the grid is the batch); eight
// lanes per row of the map, four rows per warp, ceil((n + m + 1) / 4)
// warps. Each lane keeps SLOTS consecutive columns of its row of [T1 | T2]
// in registers for the whole block of iterations, so an iteration reads the
// vector v = (s, z), double-buffered in shared memory, with 16-byte loads,
// runs SLOTS FMAs, sums its row over the 8 lanes by shuffles, and the row's
// first lane writes s+ and, for a w row, z+ = clamp(w+, l, u) into the
// other buffer: one __syncthreads per iteration, z computed once by its
// writer. Columns past n + 2m + 1 are zeros in both the maps and v, so the
// loop has no bounds to test. A block's set-up: the inputs staged into
// shared memory by coalesced loads; K and the right factor W = [sigma I |
// -rho A^T | q | rho A^T] (n x columns) together; warp 0 factors K and
// inverts its factor in shared memory (factor_and_invert); K^-1 and E by
// all threads; each lane's map entries are then E's row times W's columns,
// read as 16-byte vectors, so the map costs n FMAs an entry and no branch.
// The residuals split over warps 0 (primal) and 1 (dual), and every thread
// takes the new rho from them. n <= NMAX and m <= MMAX are runtime values;
// SLOTS = 12 serves n + 2m + 1 <= 96 (the filter's 12 x 37 is 87), SLOTS =
// 20 the rest. Loops over n stay rolled: unrolled to NMAX with predicates
// they made the kernel's code larger than the instruction cache and its
// set-up slower. On an H100 at 12 x 37 an iteration takes ~0.2 us and a
// block's set-up ~12 us, most of it the factorisation's 2n dependent
// phases; two rows a lane and two lanes a row measured slower than eight
// lanes a row (PERF.md).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NMAX = 16;  // variables
constexpr int MMAX = 64;  // constraint rows
constexpr int GROUP = 8;  // lanes per row of the maps
constexpr int ROWS_PER_WARP = 32 / GROUP;
constexpr int RMAX = NMAX + MMAX + 1;  // rows of s = (x, w, 1)
constexpr int LD = NMAX + 1;  // row stride of the matrices: odd, so a column's entries lie in distinct banks
constexpr int WIDE_SLOTS = 20;
constexpr int NARROW_SLOTS = 12;
// Threads of a block: four rows a warp. Past n + 2m + 1 = 96 columns (the
// wide maps) up to RMAX = 81 rows; within them at most 56 rows (n + m + 1
// with n <= 16 and n + 2m + 1 <= 96), so 448 threads and up to 128
// registers a thread.
constexpr int WIDE_THREADS = 32 * ((RMAX + ROWS_PER_WARP - 1) / ROWS_PER_WARP);  // 672
constexpr int NARROW_ROWS = NMAX + (GROUP * NARROW_SLOTS - 1 - NMAX) / 2 + 1;       // 56
constexpr int NARROW_THREADS = 32 * ((NARROW_ROWS + ROWS_PER_WARP - 1) / ROWS_PER_WARP);  // 448
constexpr int VMAX = GROUP * WIDE_SLOTS;  // 160 >= NMAX + 2 MMAX + 1 = 145
static_assert(VMAX >= NMAX + 2 * MMAX + 1, "v must hold (s, z)");

template <typename T>
struct Problem {
  alignas(16) T v[2][VMAX];  // (x, w, 1, z), double-buffered; zeros past n + 2m + 1
  alignas(16) T W[NMAX][VMAX];  // the maps' right factor, zeros past n + 2m + 1
  T A[MMAX * LD];            // the rows, then scaled
  T P[NMAX * LD];
  T AtA[NMAX * LD];
  T L[NMAX * LD];            // K = P + sigma I + rho A^T A, then its Cholesky factor (lower triangle)
  T Linv[NMAX * LD];
  T Kinv[NMAX * LD];
  T E[(NMAX + MMAX) * LD];   // [I; A] K^-1
  T q[NMAX], x[NMAX];
  T l[MMAX], u[MMAX], scale[MMAX], z[MMAX], y[MMAX];
  T residuals[4];  // max |A x - z|, max(|A x|, |z|), max |P x + q + A^T y|, max(|P x|, |q|)
};

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ float magnitude(float v) { return fabsf(v); }
__device__ __forceinline__ double magnitude(double v) { return fabs(v); }
__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return sqrt(v); }

// torch.maximum / torch.minimum: NaN if either is NaN.
template <typename T> __device__ __forceinline__ T nan_max(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T> __device__ __forceinline__ T nan_min(T a, T b) { return (a < b || a != a) ? a : b; }
template <typename T> __device__ __forceinline__ T clamp(T v, T lo, T hi) { return nan_min(nan_max(v, lo), hi); }

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

// SLOTS consecutive values from 16-byte-aligned shared memory.
template <typename T, int SLOTS>
__device__ __forceinline__ void load_row(const T* from, T (&to)[SLOTS]) {
  using V = typename Vec16<T>::type;
  constexpr int PER_VEC = 16 / sizeof(T);
  static_assert(SLOTS % PER_VEC == 0, "whole 16-byte vectors");
#pragma unroll
  for (int k = 0; k < SLOTS / PER_VEC; ++k) {
    const V chunk = reinterpret_cast<const V*>(from)[k];
    const T* parts = reinterpret_cast<const T*>(&chunk);
#pragma unroll
    for (int w = 0; w < PER_VEC; ++w) to[k * PER_VEC + w] = parts[w];
  }
}

// Warp 0: L from K in place in shared memory, NaN throughout if a pivot is
// not positive (LAPACK's test), and L^-1 beside it by forward substitution,
// both right-looking and interleaved. Step j is two phases between
// __syncwarp: (a) column j of L scaled by its pivot's root (a lane a row)
// and the rows of L^-1 below j - 1 updated by row j - 1; (b) the pivot
// written, the trailing block of L updated and row j of L^-1 divided by
// the pivot's root (a lane a column). The lanes spread over the NMAX^2
// entries, each pass loading every operand it may need before any store,
// so a phase costs a few shared-memory round trips whatever n is.
template <typename T>
__device__ void factor_and_invert(Problem<T>& p, int n, int lane) {
  constexpr int PASSES = NMAX * NMAX / 32;
  static_assert(NMAX * NMAX % 32 == 0, "whole passes over the entries");
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    const int e = pass * 32 + lane, i = e / NMAX, k = e % NMAX;
    p.Linv[i * LD + k] = i == k ? T(1) : T(0);
  }
  __syncwarp();
  bool failed = false;
  for (int j = 0; j < n; ++j) {
    const T d = p.L[j * LD + j];
    failed |= !(d > T(0));
    const T diagonal = root(d);
    if (lane > j && lane < n) p.L[lane * LD + j] /= diagonal;
    if (j > 0) {
      T entry[PASSES], update[PASSES];
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        const int e = pass * 32 + lane, i = e / NMAX, k = e % NMAX;
        entry[pass] = p.Linv[i * LD + k];
        update[pass] = p.L[i * LD + j - 1] * p.Linv[(j - 1) * LD + k];
      }
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        const int e = pass * 32 + lane, i = e / NMAX, k = e % NMAX;
        if (i >= j && i < n && k < j) p.Linv[i * LD + k] = entry[pass] - update[pass];
      }
    }
    __syncwarp();
    if (lane == j) p.L[j * LD + j] = diagonal;
    if (lane <= j) p.Linv[j * LD + lane] /= diagonal;
    T entry[PASSES], update[PASSES];
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int e = pass * 32 + lane, i = e / NMAX, k = e % NMAX;
      entry[pass] = p.L[i * LD + k];
      update[pass] = p.L[i * LD + j] * p.L[k * LD + j];
    }
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int e = pass * 32 + lane, i = e / NMAX, k = e % NMAX;
      if (k > j && k <= i && i < n) p.L[i * LD + k] = entry[pass] - update[pass];
    }
    __syncwarp();
  }
  if (failed) {
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int e = pass * 32 + lane, i = e / NMAX, k = e % NMAX;
      p.L[i * LD + k] = p.Linv[i * LD + k] = T(NAN);
    }
    __syncwarp();
  }
}

// Warps 0 and 1 (warp 0 alone in a one-warp block): the residuals' four
// maxima into p.residuals.
template <typename T>
__device__ void residuals(Problem<T>& p, int n, int m, int warp, int warps, int lane) {
  if (warp == 0) {
    T primal = 0, ax_top = 0, z_top = 0;
    for (int j = lane; j < m; j += 32) {
      T ax = 0;
      for (int k = 0; k < n; ++k) ax += p.A[j * LD + k] * p.x[k];
      primal = nan_max(primal, magnitude(ax - p.z[j]));
      ax_top = nan_max(ax_top, magnitude(ax));
      z_top = nan_max(z_top, magnitude(p.z[j]));
    }
    primal = warp_max(primal);
    const T top = nan_max(warp_max(ax_top), warp_max(z_top));
    if (lane == 0) {
      p.residuals[0] = primal;
      p.residuals[1] = top;
    }
  }
  if (warp == (warps > 1 ? 1 : 0)) {
    T dual = 0, px_top = 0, q_top = 0;
    for (int a = lane; a < n; a += 32) {
      T px = 0, aty = 0;
      for (int k = 0; k < n; ++k) px += p.P[a * LD + k] * p.x[k];
      for (int j = 0; j < m; ++j) aty += p.A[j * LD + a] * p.y[j];
      dual = nan_max(dual, magnitude(px + p.q[a] + aty));
      px_top = nan_max(px_top, magnitude(px));
      q_top = nan_max(q_top, magnitude(p.q[a]));
    }
    dual = warp_max(dual);
    const T top = nan_max(warp_max(px_top), warp_max(q_top));
    if (lane == 0) {
      p.residuals[2] = dual;
      p.residuals[3] = top;
    }
  }
}

template <typename T, int SLOTS>
__global__ void __launch_bounds__(SLOTS == NARROW_SLOTS ? NARROW_THREADS : WIDE_THREADS)
admm_qp_kernel(const T* __restrict__ P_in, const T* __restrict__ q_in, const T* __restrict__ A_in,
               const T* __restrict__ l_in, const T* __restrict__ u_in, const T* __restrict__ x0_in,
               T* __restrict__ out, int n, int m, int iterations, int blocks, T rho, T sigma, T alpha,
               T keep_x, T two_alpha) {
  extern __shared__ __align__(16) unsigned char shared[];
  Problem<T>& p = *reinterpret_cast<Problem<T>*>(shared);
  const int tid = threadIdx.x, threads = blockDim.x, warp = tid / 32, lane = tid % 32, warps = threads / 32;
  const int R = n + m + 1, C = R + m;  // rows of s; columns of [T1 | T2]
  constexpr int COLUMNS = GROUP * SLOTS;  // columns held, zeros past C
  const long long b = blockIdx.x;
  P_in += b * n * n;
  q_in += b * n;
  A_in += b * m * n;
  l_in += b * m;
  u_in += b * m;
  if (x0_in != nullptr) x0_in += b * n;
  out += b * (n + 2 * m + 2);

  // The inputs, staged by coalesced loads.
  for (int i = tid; i < m * n; i += threads) p.A[(i / n) * LD + i % n] = A_in[i];
  for (int i = tid; i < n * n; i += threads) {
    const int a = i / n, c = i % n;
    p.P[a * LD + c] = P_in[i];
  }
  for (int k = tid; k < n; k += threads) {
    p.q[k] = q_in[k];
    p.x[k] = x0_in != nullptr ? x0_in[k] : T(0);
  }
  for (int j = tid; j < m; j += threads) {
    p.l[j] = l_in[j];
    p.u[j] = u_in[j];
  }
  for (int i = tid; i < 2 * VMAX; i += threads) (&p.v[0][0])[i] = T(0);
  __syncthreads();
  // The rows equilibrated: scale_j = 1 / max(max_k |A_jk|, 1e-8).
  for (int j = tid; j < m; j += threads) {
    T top = 0;
    for (int k = 0; k < n; ++k) top = nan_max(top, magnitude(p.A[j * LD + k]));
    const T s = T(1) / nan_max(top, T(1e-8));
    p.scale[j] = s;
    for (int k = 0; k < n; ++k) p.A[j * LD + k] *= s;
    p.l[j] *= s;
    p.u[j] *= s;
  }
  __syncthreads();
  // A^T A; the first z = clamp(A x0, l, u) and y = 0.
  for (int i = tid; i < n * n; i += threads) {
    const int a = i / n, c = i % n;
    T sum = 0;
    for (int j = 0; j < m; ++j) sum += p.A[j * LD + a] * p.A[j * LD + c];
    p.AtA[a * LD + c] = sum;
  }
  for (int j = tid; j < m; j += threads) {
    T ax = 0;
    for (int k = 0; k < n; ++k) ax += p.A[j * LD + k] * p.x[k];
    p.z[j] = clamp(ax, p.l[j], p.u[j]);
    p.y[j] = 0;
  }
  __syncthreads();

  // This thread's row of the maps and its first column.
  const int row = warp * ROWS_PER_WARP + lane / GROUP;
  const int c0 = (lane % GROUP) * SLOTS;
  const bool writer = lane % GROUP == 0 && row < R;
  const bool w_row = row >= n && row < n + m;
  const T lo = w_row ? p.l[row - n] : T(0), hi = w_row ? p.u[row - n] : T(0);

  for (int block = 0;; ++block) {
    // K = P + sigma I + rho A^T A (into L, which the factorisation
    // overwrites), and W.
    for (int i = tid; i < n * n; i += threads) {
      const int a = i / n, c = i % n;
      p.L[a * LD + c] = (p.P[a * LD + c] + (a == c ? sigma : T(0))) + rho * p.AtA[a * LD + c];
    }
    for (int i = tid; i < n * COLUMNS; i += threads) {
      const int k = i / COLUMNS, col = i % COLUMNS;
      T value = 0;
      if (col < n) {
        value = col == k ? sigma : T(0);
      } else if (col < n + m) {
        value = -(rho * p.A[(col - n) * LD + k]);
      } else if (col == n + m) {
        value = p.q[k];
      } else if (col < C) {
        value = rho * p.A[(col - R) * LD + k];
      }
      p.W[k][col] = value;
    }
    __syncthreads();
    if (warp == 0) factor_and_invert(p, n, lane);
    __syncthreads();
    for (int i = tid; i < n * n; i += threads) {
      const int a = i / n, c = i % n;
      T sum = 0;
#pragma unroll 4
      for (int k = 0; k < n; ++k) sum += p.Linv[k * LD + a] * p.Linv[k * LD + c];
      p.Kinv[a * LD + c] = sum;
    }
    __syncthreads();
    for (int i = tid; i < (n + m) * n; i += threads) {
      const int r = i / n, c = i % n;
      T value;
      if (r < n) {
        value = p.Kinv[r * LD + c];
      } else {
        value = 0;
#pragma unroll 4
        for (int k = 0; k < n; ++k) value += p.A[(r - n) * LD + k] * p.Kinv[k * LD + c];
      }
      p.E[r * LD + c] = value;
    }
    __syncthreads();

    // The maps, E W scaled and offset: T1 = keep + alpha E [sigma I, -rho
    // A^T] with (E q) (-alpha) as its last column and (0, ..., 0, 1) as its
    // last row, keep = diag(1 - alpha (x), 1 (w)); T2 = -alpha [0; I] +
    // 2 alpha E rho A^T.
    T t[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) t[s] = 0;
    if (row < n + m) {
#pragma unroll 1
      for (int k = 0; k < n; ++k) {
        const T e = p.E[row * LD + k];
        T w[SLOTS];
        load_row(&p.W[k][c0], w);
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) t[s] = fma(e, w[s], t[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int col = c0 + s;
      T value = 0;
      if (row < n + m) {
        if (col < n + m) {
          value = (row == col ? (col < n ? keep_x : T(1)) : T(0)) + alpha * t[s];
        } else if (col == n + m) {
          value = t[s] * -alpha;
        } else if (col < C) {
          value = (row - n == col - R ? -alpha : T(0)) + two_alpha * t[s];
        }
      } else if (row == n + m) {
        value = col == n + m ? T(1) : T(0);
      }
      t[s] = value;
    }
    // The first v: (x, z + y / rho, 1, clamp(z + y / rho, l, u)).
    for (int i = tid; i < C; i += threads) {
      T value;
      if (i < n) {
        value = p.x[i];
      } else if (i < n + m) {
        value = p.z[i - n] + p.y[i - n] / rho;
      } else if (i == n + m) {
        value = T(1);
      } else {
        const int j = i - R;
        value = clamp(p.z[j] + p.y[j] / rho, p.l[j], p.u[j]);
      }
      p.v[0][i] = value;
    }
    __syncthreads();

    for (int it = 0; it < iterations; ++it) {
      const T* src = p.v[it & 1];
      T* dst = p.v[(it & 1) ^ 1];
      T vals[SLOTS];
      load_row(src + c0, vals);
      T acc[2] = {T(0), T(0)};
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) acc[s & 1] = fma(t[s], vals[s], acc[s & 1]);
      T sum = acc[0] + acc[1];
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (writer) {
        dst[row] = sum;
        if (w_row) dst[R + row - n] = clamp(sum, lo, hi);
      }
      __syncthreads();
    }

    const T* s = p.v[iterations & 1];
    for (int k = tid; k < n; k += threads) p.x[k] = s[k];
    for (int j = tid; j < m; j += threads) {
      const T w = s[n + j];
      const T zj = clamp(w, p.l[j], p.u[j]);
      p.z[j] = zj;
      p.y[j] = rho * (w - zj);
    }
    __syncthreads();
    residuals(p, n, m, warp, warps, lane);
    __syncthreads();
    if (block == blocks - 1) break;
    // Residual-balanced rho, taken by every thread from the same maxima.
    const T* r = p.residuals;
    const T ratio = root((r[0] / nan_max(r[1], T(1e-12))) / nan_max(r[2] / nan_max(r[3], T(1e-12)), T(1e-12)));
    rho = clamp(rho * clamp(ratio, T(1e-3), T(1e3)), T(1e-6), T(1e6));
  }

  for (int k = tid; k < n; k += threads) out[k] = p.x[k];
  for (int j = tid; j < m; j += threads) {
    out[n + j] = p.z[j] / p.scale[j];
    out[n + m + j] = p.y[j] * p.scale[j];
  }
  if (tid == 0) {
    out[n + 2 * m] = p.residuals[0];
    out[n + 2 * m + 1] = p.residuals[2];
  }
}

template <typename T, int SLOTS>
int launch_slots(const T* P, const T* q, const T* A, const T* l, const T* u, const T* x0, T* out, int N, int n,
                 int m, int iterations, int blocks, double rho, double sigma, double alpha, int threads,
                 cudaStream_t stream) {
  constexpr size_t bytes = sizeof(Problem<T>);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        admm_qp_kernel<T, SLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  // The scalars rounded as PyTorch rounds them in the plain version.
  admm_qp_kernel<T, SLOTS><<<N, threads, bytes, stream>>>(
      P, q, A, l, u, x0, out, n, m, iterations, blocks, T(rho), T(sigma), T(alpha), T(1.0 - alpha),
      T(2.0 * alpha));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* P, const void* q, const void* A, const void* l, const void* u, const void* x0, void* out,
           int N, int n, int m, int iterations, int blocks, double rho, double sigma, double alpha,
           cudaStream_t stream) {
  const int R = n + m + 1, C = R + m;
  const int threads = 32 * ((R + ROWS_PER_WARP - 1) / ROWS_PER_WARP);
  const auto* P_ = static_cast<const T*>(P);
  const auto* q_ = static_cast<const T*>(q);
  const auto* A_ = static_cast<const T*>(A);
  const auto* l_ = static_cast<const T*>(l);
  const auto* u_ = static_cast<const T*>(u);
  const auto* x0_ = static_cast<const T*>(x0);
  auto* out_ = static_cast<T*>(out);
  if (C <= GROUP * NARROW_SLOTS && threads <= NARROW_THREADS) {
    return launch_slots<T, NARROW_SLOTS>(P_, q_, A_, l_, u_, x0_, out_, N, n, m, iterations, blocks, rho, sigma,
                                         alpha, threads, stream);
  }
  return launch_slots<T, WIDE_SLOTS>(P_, q_, A_, l_, u_, x0_, out_, N, n, m, iterations, blocks, rho, sigma, alpha,
                                     threads, stream);
}

}  // namespace

extern "C" {

// The compiled maxima of n (variables) and m (constraint rows).
int aq_max_n() { return NMAX; }
int aq_max_m() { return MMAX; }

// Solve N problems of n variables and m rows on `stream`: P (N, n, n), q
// (N, n), A (N, m, n), l and u (N, m), x0 (N, n) or NULL (zeros), all
// contiguous, of float (dtype 0) or double (1); out (N, n + 2m + 2) = (x,
// z, y, primal residual, dual residual) per problem. Returns the
// cudaError_t of the launch (0 = success), cudaErrorInvalidValue for sizes
// or a dtype it does not take.
int aq_launch(int dtype, const void* P, const void* q, const void* A, const void* l, const void* u, const void* x0,
              void* out, int N, int n, int m, int iterations, int blocks, double rho, double sigma, double alpha,
              void* stream) {
  if (N < 1 || n < 1 || n > NMAX || m < 0 || m > MMAX || iterations < 0 || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(P, q, A, l, u, x0, out, N, n, m, iterations, blocks, rho, sigma, alpha, s);
    case 1: return launch<double>(P, q, A, l, u, x0, out, N, n, m, iterations, blocks, rho, sigma, alpha, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
