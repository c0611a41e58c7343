// A tensor-network contraction step with a small operand, read and written
// at the legs where they lie.
//
// No Pallas counterpart: the JAX package computes these steps with XLA
// dot_general (hybridq_tpu/simulation/tn/contract.py:101-121, and the flat
// executor's gathered matmuls, :156-213).  The port's executor
// (simulation/tn/contract.py) sends here every step whose smaller operand
// sums s <= 7 legs of the larger one and brings f <= 7 new legs, with no
// retained hyperedge; on the Sycamore-53 plans that is nearly every step of
// a slice and about nine tenths of its bytes.
//
// The step.  X, the larger operand, has nx legs of size 2 (flat index: leg
// bits, the slice batch in front); the operator O has s + f legs at any
// bits of its own.  For each column c (a combination of X's nx - s untouched
// legs) and each batch entry,
//     y[c, j] = sum_i O[j, i] x[c, i],
// i over the 2^s values of the summed legs (bit s-1-t of i is summed leg t,
// at X bit xbits[t] and O bit ocol[t]) and j over the 2^f values of the new
// legs (bit f-1-u of j is new leg u, at O bit orow[u] and Y bit ybits[u]).
// Y keeps X's untouched legs in their order; the host picks ybits (the
// summed legs' places, and the top bits for legs beyond them).  X, O or
// both may be batched (a stride of 0 otherwise); Y is batched if either
// is.  With f == s and ybits == xbits, y may be x: each thread (column
// kernel) or block (tile kernel) reads all of its columns before it writes
// them, and no two own a column.
//
// Bound on this card: bytes.  A step reads X and writes Y once, 8 *
// (2^nx + 2^ny) bytes a batch entry (16 in complex128), and does
// 8 * 2^(nx - s + s + f) real flops; at 3.35 TB/s and 67 TFLOP/s of fp32
// the flops stay under the bytes' time while 2^(s+f) / (2^s + 2^f) <= 20,
// which holds for s = f <= 5 and for every class of the Sycamore plans but
// a few with s, f of 6-7.  What the design does about that bound:
//   * No permute copy: torch.tensordot first copies X to bring the summed
//     legs last, runs a product tiled for square operands, and leaves the
//     new legs last for the next step to copy again.  Here every byte of X
//     is read once from where it lies and every byte of Y written once.
//   * tn_column_kernel<R, S>, s <= 5: one column a thread, its 2^s inputs
//     in registers (loaded straight from device memory, all issued before
//     anything waits on them), the 2^f outputs computed one at a time and
//     stored straight back, so registers hold 2^s complex values whatever
//     f is.  The operator is gathered into shared memory while the loads
//     are in flight and read as a broadcast.  Consecutive threads take
//     consecutive columns, so a warp's load of input i is 32 neighbouring
//     elements of X when the summed legs avoid bits 0-4, and stays within
//     one or two 128-byte lines a pair of inputs otherwise (the lowest
//     summed bits split a line between inputs of one thread, which L1
//     serves); stores likewise.  This is fused_apply.cu's
//     column_apply_kernel<K>, with the operator's legs and Y's layout as
//     arguments.
//   * tn_tile_kernel<R, S>, s = 6, 7: 2^s inputs do not fit in registers.
//     A block stages a tile of 32 columns x 2^s inputs in shared memory
//     (loads along the columns, coalesced), then each warp computes rows of
//     Y four at a time for its 32 columns in fp32 (fp64) FMAs, the
//     operator read through L1 as a broadcast.  TF32 is never used: the
//     executor promises full precision.
// Indexing is 64-bit throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLegs = 7;          // s and f
constexpr int kColumnS = 5;          // largest s of tn_column_kernel
constexpr int kTileCols = 32;        // columns of a tn_tile_kernel tile
constexpr int kTileRows = 4;         // rows of Y a thread computes at once
constexpr int kStaticSmem = 48 * 1024;

template <typename R> struct Complex;
template <> struct Complex<float> { using T = float2; };
template <> struct Complex<double> { using T = double2; };

struct StepArgs {
  int s, f;
  int log_cols;                      // nx - s: untouched legs of X
  int xbits[kMaxLegs];               // X bit of summed leg t
  int xsort[kMaxLegs];               // xbits ascending
  int ybits[kMaxLegs];               // Y bit of new leg u
  int ysort[kMaxLegs];               // ybits[0..f) ascending
  int orow[kMaxLegs];                // O bit of new leg u
  int ocol[kMaxLegs];                // O bit of summed leg t
  int64_t xstride, ostride, ystride; // elements a batch entry (0: shared)
};

// The loops over StepArgs' arrays run to a compile-time bound with a guard:
// a runtime index into a kernel argument makes the compiler copy the whole
// struct to local memory.

// r with a zero inserted at each of the first n bits of `sorted`.
__device__ __forceinline__ int64_t deposit(const int (&sorted)[kMaxLegs],
                                           int n, int64_t r) {
#pragma unroll
  for (int g = 0; g < kMaxLegs; ++g)
    if (g < n) {
      const int b = sorted[g];
      r = ((r >> b) << (b + 1)) | (r & ((int64_t(1) << b) - 1));
    }
  return r;
}

// The offset of value v of n legs at `bits` (bit n-1-t of v is leg t).
__device__ __forceinline__ int64_t spread(const int (&bits)[kMaxLegs], int n,
                                         int v) {
  int64_t o = 0;
#pragma unroll
  for (int t = 0; t < kMaxLegs; ++t)
    if (t < n && ((v >> (n - 1 - t)) & 1)) o |= int64_t(1) << bits[t];
  return o;
}

// acc += u * x, complex
template <typename T, typename R>
__device__ __forceinline__ void cmac(R& ar, R& ai, const T& u, const T& x) {
  ar = fma(u.x, x.x, ar);
  ar = fma(-u.y, x.y, ar);
  ai = fma(u.x, x.y, ai);
  ai = fma(u.y, x.x, ai);
}

template <typename R, int S>
__global__ void __launch_bounds__(kThreads)
tn_column_kernel(const typename Complex<R>::T* x, typename Complex<R>::T* y,
                 const typename Complex<R>::T* op, StepArgs a,
                 int64_t total) {
  using T = typename Complex<R>::T;
  constexpr int NI = 1 << S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nf = 1 << a.f;
  T* os = reinterpret_cast<T*>(smem);                      // [2^f][2^S]
  int64_t* yoff = reinterpret_cast<int64_t*>(os + (nf << S));   // [2^f]

  const int64_t first = (int64_t)blockIdx.x * blockDim.x;
  const int64_t g = first + threadIdx.x;
  const bool live = g < total;
  const int64_t b = g >> a.log_cols;                       // batch entry
  const int64_t c = g & ((int64_t(1) << a.log_cols) - 1);  // column

  T xin[NI];
  if (live) {
    const T* xp = x + b * a.xstride + deposit(a.xsort, S, c);
#pragma unroll
    for (int i = 0; i < NI; ++i) xin[i] = xp[spread(a.xbits, S, i)];
  }
  // The operator (one batch entry a block: the host sizes blocks so) and
  // Y's row offsets into shared memory while those loads are in flight.
  const T* ob = op + (first >> a.log_cols) * a.ostride;
  for (int e = threadIdx.x; e < (nf << S); e += blockDim.x)
    os[e] = ob[spread(a.orow, a.f, e >> S) | spread(a.ocol, S, e & (NI - 1))];
  for (int j = threadIdx.x; j < nf; j += blockDim.x)
    yoff[j] = spread(a.ybits, a.f, j);
  __syncthreads();
  if (!live) return;

  T* yp = y + b * a.ystride + deposit(a.ysort, a.f, c);
  for (int j = 0; j < nf; ++j) {
    const T* row = os + (j << S);
    R ar = 0, ai = 0;
#pragma unroll
    for (int i = 0; i < NI; ++i) cmac(ar, ai, row[i], xin[i]);
    T out;
    out.x = ar;
    out.y = ai;
    yp[yoff[j]] = out;
  }
}

template <typename R, int S>
__global__ void __launch_bounds__(kThreads)
tn_tile_kernel(const typename Complex<R>::T* x, typename Complex<R>::T* y,
               const typename Complex<R>::T* op, StepArgs a,
               int64_t tiles) {
  using T = typename Complex<R>::T;
  constexpr int NI = 1 << S;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nf = 1 << a.f;
  T* xs = reinterpret_cast<T*>(smem);                      // [2^S][32]
  int64_t* yoff = reinterpret_cast<int64_t*>(xs + NI * kTileCols);
  int* orow = reinterpret_cast<int*>(yoff + nf);           // [2^f]
  int* ocol = orow + nf;                                   // [2^S]

  const int64_t b = blockIdx.x / tiles;                    // batch entry
  const int64_t c = (blockIdx.x % tiles) * kTileCols + threadIdx.x % 32;
  const bool live = c < (int64_t(1) << a.log_cols);
  const int warp = threadIdx.x / 32;

  const T* xp = x + b * a.xstride + (live ? deposit(a.xsort, S, c) : 0);
  for (int i = warp; i < NI; i += kWarps) {
    T v;
    v.x = v.y = 0;
    if (live) v = xp[spread(a.xbits, S, i)];
    xs[i * kTileCols + threadIdx.x % 32] = v;
  }
  for (int j = threadIdx.x; j < nf; j += kThreads) {
    yoff[j] = spread(a.ybits, a.f, j);
    orow[j] = (int)spread(a.orow, a.f, j);
  }
  for (int i = threadIdx.x; i < NI; i += kThreads)
    ocol[i] = (int)spread(a.ocol, S, i);
  // Every read of the tile's columns lands before any write (in place).
  __syncthreads();

  const T* ob = op + b * a.ostride;
  T* yp = y + b * a.ystride + (live ? deposit(a.ysort, a.f, c) : 0);
  const T* xc = xs + threadIdx.x % 32;
  for (int j0 = warp * kTileRows; j0 < nf; j0 += kWarps * kTileRows) {
    const T* rows[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
      rows[r] = ob + orow[min(j0 + r, nf - 1)];
    R ar[kTileRows] = {}, ai[kTileRows] = {};
#pragma unroll 4
    for (int i = 0; i < NI; ++i) {
      const T xv = xc[i * kTileCols];
      const int oc = ocol[i];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
        cmac(ar[r], ai[r], __ldg(rows[r] + oc), xv);
    }
    if (live)
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
        if (j0 + r < nf) {
          T out;
          out.x = ar[r];
          out.y = ai[r];
          yp[yoff[j0 + r]] = out;
        }
  }
}

template <typename R, int S>
cudaError_t launch(const void* x, void* y, const void* op, const StepArgs& a,
                   int64_t batch, cudaStream_t stream) {
  using T = typename Complex<R>::T;
  const int nf = 1 << a.f;
  const int64_t total = batch << a.log_cols;
  if constexpr (S <= kColumnS) {
    // a block's columns share one batch entry when the operator is batched
    const int threads = a.ostride && a.log_cols < 8 ? 1 << a.log_cols
                                                    : kThreads;
    const int64_t blocks = (total + threads - 1) / threads;
    const size_t smem = (size_t)(nf << S) * sizeof(T) + nf * sizeof(int64_t);
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    auto* kern = tn_column_kernel<R, S>;
    if (smem > kStaticSmem) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kern<<<(unsigned)blocks, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<const T*>(op), a, total);
  } else {
    const int64_t tiles =
        ((int64_t(1) << a.log_cols) + kTileCols - 1) / kTileCols;
    const int64_t blocks = batch * tiles;
    const size_t smem = (size_t)(1 << S) * kTileCols * sizeof(T) +
                        nf * (sizeof(int64_t) + sizeof(int)) +
                        (1 << S) * sizeof(int);
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    auto* kern = tn_tile_kernel<R, S>;
    if (smem > kStaticSmem) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<const T*>(op), a, tiles);
  }
  return cudaGetLastError();
}

template <typename R>
cudaError_t dispatch(const void* x, void* y, const void* op,
                     const StepArgs& a, int64_t batch, cudaStream_t stream) {
  switch (a.s) {
    case 0: return launch<R, 0>(x, y, op, a, batch, stream);
    case 1: return launch<R, 1>(x, y, op, a, batch, stream);
    case 2: return launch<R, 2>(x, y, op, a, batch, stream);
    case 3: return launch<R, 3>(x, y, op, a, batch, stream);
    case 4: return launch<R, 4>(x, y, op, a, batch, stream);
    case 5: return launch<R, 5>(x, y, op, a, batch, stream);
    case 6: return launch<R, 6>(x, y, op, a, batch, stream);
    default: return launch<R, 7>(x, y, op, a, batch, stream);
  }
}

void sort_bits(const int* in, int n, int* out) {
  for (int i = 0; i < n; ++i) out[i] = in[i];
  for (int i = 1; i < n; ++i)          // insertion sort, ascending
    for (int j = i; j > 0 && out[j - 1] > out[j]; --j) {
      const int t = out[j];
      out[j] = out[j - 1];
      out[j - 1] = t;
    }
}

bool bits_ok(const int* bits, int n, int width) {
  int64_t seen = 0;
  for (int i = 0; i < n; ++i) {
    if (bits[i] < 0 || bits[i] >= width || (seen >> bits[i]) & 1)
      return false;
    seen |= int64_t(1) << bits[i];
  }
  return true;
}

}  // namespace

// The step as tn_kernels.TnStep describes it (its ctypes mirror).
struct TnDesc {
  int nx, s, f, x_batched, op_batched;
  int xbits[kMaxLegs], ybits[kMaxLegs], orow[kMaxLegs], ocol[kMaxLegs];
};

// y[b, c, j] = sum_i op[b, j, i] x[b, c, i] for `batch` entries; elements
// are complex64 (double_precision == 0) or complex128.  Returns the CUDA
// error of the launch (cudaGetLastError), or cudaErrorInvalidValue for a
// step out of range.
extern "C" int hq_tn_apply(const void* x, void* y, const void* op,
                           long long batch, const TnDesc* d,
                           int double_precision, void* stream) {
  const int ny = d->nx - d->s + d->f;
  if (d->s < 0 || d->s > kMaxLegs || d->f < 0 || d->f > kMaxLegs ||
      d->nx < d->s || d->nx > 48 || ny > 48 || batch < 1 ||
      !bits_ok(d->xbits, d->s, d->nx) || !bits_ok(d->ybits, d->f, ny) ||
      !bits_ok(d->orow, d->f, d->s + d->f) ||
      !bits_ok(d->ocol, d->s, d->s + d->f))
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < d->s; ++t)       // operator legs: distinct in all
    for (int u = 0; u < d->f; ++u)
      if (d->ocol[t] == d->orow[u]) return (int)cudaErrorInvalidValue;
  StepArgs a = {};
  a.s = d->s;
  a.f = d->f;
  a.log_cols = d->nx - d->s;
  for (int t = 0; t < d->s; ++t) {
    a.xbits[t] = d->xbits[t];
    a.ocol[t] = d->ocol[t];
  }
  for (int u = 0; u < d->f; ++u) {
    a.ybits[u] = d->ybits[u];
    a.orow[u] = d->orow[u];
  }
  sort_bits(d->xbits, d->s, a.xsort);
  sort_bits(d->ybits, d->f, a.ysort);
  a.xstride = d->x_batched ? int64_t(1) << d->nx : 0;
  a.ostride = d->op_batched ? int64_t(1) << (d->s + d->f) : 0;
  a.ystride = int64_t(1) << ny;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      double_precision ? dispatch<double>(x, y, op, a, batch, st)
                       : dispatch<float>(x, y, op, a, batch, st);
  return (int)err;
}
