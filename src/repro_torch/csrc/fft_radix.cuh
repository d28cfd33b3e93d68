// The radix path of the four-step kernel: power-of-two N = N1*N2 on
// Hopper, with in-register sub-DFTs.
//
// Replaces, for these N, the dense contractions of the TPU kernel
// src/repro/kernels/fft_matmul.py::_fft_kernel (and its twiddle and
// pack_parts epilogues), as fft_fourstep.cu's dense kernel does for any N.
//
// What bounds it on an H100: a length-N DFT needs about 5*log2(N) flops
// per element against 16 bytes of complex64 moved, about 3 flops per byte
// at N = 512, far below the 20 at which the fp32 CUDA cores (67 TFLOP/s)
// and HBM (3.35 TB/s) break even.  So HBM bytes bound it, and the design
// keeps every byte read once and written once and enough loads in flight:
//  * Column pass: a thread loads its (line, m2) column of N1 values
//    straight from global memory into registers (a warp reads consecutive
//    addresses; N1 independent loads in flight per thread), transforms it
//    with a fully unrolled radix-2 codelet, multiplies by T[k1, m2] and
//    stores it in the tile in shared memory.
//  * Row pass: a thread reads its (line, k1) row of N2 values from the
//    tile, transforms it and writes out[k1 + N1*k2] with the epilogue:
//    the output twiddle, the 1/N scale, the pack_parts segment store.  A
//    warp's stores for one k2 cover N1 consecutive elements of a line
//    (strided: consecutive inner indices), so they fill whole sectors.
//  * The codelets' twiddles come from one table of W_N2^k, k < N2/2, and
//    T from an N-element table, both built in float64 on the host
//    (kernels/fft_matmul.py::_radix_constants) and kept in shared memory.
//    The codelets, loads and stores unroll at compile time (static_for),
//    so every index into the register arrays and the codelet table is a
//    constant expression.
//  * The tile: (line, k1, m2) with a row pitch of N2 + 1 for contiguous
//    lines, so the row pass's reads down k1 hit distinct banks; (k1, m2,
//    line) for strided lines, where threads run along the line index.
//  * A persistent grid: as many blocks as fit on the SMs, each walking
//    over tiles, so the constants are loaded once per block.
// The dense W1/W2 matrices are gone from this path: about 5*log2(N) + 6
// flops per element instead of 8*(N1+N2).
//
// Strided lines: a contiguous (outer, N, inner) block transformed along
// dim 1 in place of the (B, N) lines, so the line wrapper needs no
// movedim+contiguous copy for a strided axis (kernels/ops.py::_apply).
// A tile is one outer index, all N and `lines` consecutive inner indices;
// the last group of inner indices is masked.
//
// kernels/radix.py holds the same plan, tiles and index maps in Python
// (radix.emulate runs them), and the CPU tests hold them against np.fft.
#pragma once

#include <climits>

#include "fft_common.cuh"

namespace repro_fft {

constexpr int kRadixThreads = 256;

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// i with its low `bits` bits reversed.
__host__ __device__ constexpr int bitrev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) {
    r = (r << 1) | (i & 1);
    i >>= 1;
  }
  return r;
}

// A compile-time integer, passed to the bodies of static_for.
template <int I>
struct Int {
  static constexpr int value = I;
};

// f(Int<I>()) for I = B, ..., E-1, unrolled at compile time: every index
// into a codelet's register array is a constant expression, so the array
// never needs local memory.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F& f) {
  if constexpr (B < E) {
    f(Int<B>());
    static_for<B + 1, E>(f);
  }
}

// Stages M, 2M, ..., L of an in-register radix-2 decimation-in-time FFT
// of length L: v holds the input in bit-reversed order and ends in natural
// order.  w[k] = exp(sign*2*pi*i*k/WL), k < WL/2, with L dividing WL.
template <int L, int WL, int M, typename R>
__device__ __forceinline__ void fft_stages(cpx<R> (&v)[L],
                                           const cpx<R>* __restrict__ w) {
  if constexpr (M <= L) {
    constexpr int H = M / 2;
    // butterfly q of the stage: (b + j, b + j + H), b = (q / H) * M
    auto fly = [&](auto q) {
      constexpr int b = (decltype(q)::value / H) * M;
      constexpr int j = decltype(q)::value % H;
      cpx<R> t = v[b + j + H];
      if constexpr (j != 0) t = cmul(t, w[j * (WL / M)]);
      const cpx<R> u = v[b + j];
      v[b + j] = cadd(u, t);
      v[b + j + H] = csub(u, t);
    };
    static_for<0, L / 2>(fly);
    fft_stages<L, WL, 2 * M, R>(v, w);
  }
}

// Shared memory, in this order: T (N), the codelet table (N2/2), the
// output twiddle (N, when tw is given) and the tile; the wrapper sizes it
// (kernels/radix.py::radix_tile).  `out` is (parts, outer, N/parts) for
// contiguous lines with seg_log2 = log2(N/parts), or (outer, N, inner)
// when `strided`.
template <typename R, int N1, int N2>
__global__ void __launch_bounds__(kRadixThreads)
radix_kernel(const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
             const cpx<R>* __restrict__ consts,
             const cpx<R>* __restrict__ gtw, long long outer,
             long long inner, int inverse, int seg_log2, int lines_log2,
             int strided) {
  constexpr int N = N1 * N2;
  constexpr int NW = N2 / 2;
  constexpr int B1 = ilog2(N1);
  constexpr int B2 = ilog2(N2);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cpx<R>* const st = reinterpret_cast<cpx<R>*>(smem_raw);
  cpx<R>* const sw = st + N;
  cpx<R>* const stw = sw + NW;
  cpx<R>* const tile = stw + (gtw != nullptr ? N : 0);

  for (int i = threadIdx.x; i < N + NW; i += kRadixThreads) st[i] = consts[i];
  if (gtw != nullptr)
    for (int i = threadIdx.x; i < N; i += kRadixThreads) stw[i] = gtw[i];
  __syncthreads();

  const int L = 1 << lines_log2;
  // Lines of a tile are consecutive lines, or consecutive inner indices.
  // Tile indices are 32-bit (the launcher checks the count): a 64-bit
  // division would be a subroutine call, whose calling convention costs
  // spills.
  const long long nlines = strided ? inner : outer;
  const int groups = strided ? (int)((inner + L - 1) >> lines_log2) : 1;
  const int ntiles = strided ? (int)(outer * groups)
                             : (int)((outer + L - 1) >> lines_log2);
  // Tile strides, in elements, of (line, k1, m2) and between the elements
  // of one line in global memory.
  const int sl = strided ? 1 : N1 * (N2 + 1);
  const int sr = strided ? N2 * L : N2 + 1;
  const int sc = strided ? L : 1;
  const long long js = strided ? inner : 1;
  // 1/N folded at compile time: a run-time double division would call a
  // subroutine that needs a stack frame.
  constexpr R kInvN = R(1) / R(N);
  const R scale = inverse ? kInvN : R(1);
  const int seg = 1 << seg_log2;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int o_idx = strided ? t / groups : 0;
    const long long first = (long long)(strided ? t - o_idx * groups : t)
                            << lines_log2;
    const long long block_base = (long long)o_idx * N * inner;

    // Column pass: item c -> (l, m2).
    for (int c = threadIdx.x; c < (N2 << lines_log2); c += kRadixThreads) {
      int l, m2;
      if (strided) {
        l = c & (L - 1);
        m2 = c >> lines_log2;
      } else {
        l = c >> B2;
        m2 = c & (N2 - 1);
      }
      const long long line = first + l;
      if (line >= nlines) continue;
      const long long base = strided ? block_base + line : line * N;
      const cpx<R>* src = x + base + m2 * js;
      cpx<R> v[N1];
      auto load = [&](auto i) {
        constexpr int m1 = decltype(i)::value;
        constexpr int slot = bitrev(m1, B1);
        v[slot] = src[(long long)(m1 * N2) * js];
      };
      static_for<0, N1>(load);
      fft_stages<N1, N2, 2, R>(v, sw);
      cpx<R>* dst = tile + l * sl + m2 * sc;
      auto store = [&](auto i) {
        constexpr int k1 = decltype(i)::value;
        dst[k1 * sr] = cmul(v[k1], st[k1 * N2 + m2]);
      };
      static_for<0, N1>(store);
    }
    __syncthreads();

    // Row pass: item r -> (l, k1); output index o = k1 + N1*k2.
    for (int r = threadIdx.x; r < (N1 << lines_log2); r += kRadixThreads) {
      int l, k1;
      if (strided) {
        l = r & (L - 1);
        k1 = r >> lines_log2;
      } else {
        l = r >> B1;
        k1 = r & (N1 - 1);
      }
      const long long line = first + l;
      if (line >= nlines) continue;
      const cpx<R>* srow = tile + l * sl + k1 * sr;
      cpx<R> v[N2];
      auto load = [&](auto i) {
        constexpr int m2 = decltype(i)::value;
        constexpr int slot = bitrev(m2, B2);
        v[slot] = srow[m2 * sc];
      };
      static_for<0, N2>(load);
      fft_stages<N2, N2, 2, R>(v, sw);
      auto store = [&](auto i) {
        constexpr int k2 = decltype(i)::value;
        const int o = k1 + N1 * k2;
        cpx<R> y = v[k2];
        if (gtw != nullptr) y = cmul(y, stw[o]);
        y.re *= scale;
        y.im *= scale;
        long long addr;
        if (strided) {
          addr = block_base + line + (long long)o * inner;
        } else {
          addr = (((long long)(o >> seg_log2) * outer + line) << seg_log2) +
                 (o & (seg - 1));
        }
        out[addr] = y;
      };
      static_for<0, N2>(store);
    }
    __syncthreads();  // the next tile's column pass overwrites the tile
  }
}

template <typename R, int N1, int N2>
int radix_launch(const void* x, void* out, const void* consts,
                 const void* tw, long long outer, long long inner,
                 int inverse, int seg_log2, int lines_log2, int strided,
                 int smem_bytes, cudaStream_t stream) {
  const long long lines = 1LL << lines_log2;
  const long long ntiles = strided ? outer * ((inner + lines - 1) / lines)
                                   : (outer + lines - 1) / lines;
  if (ntiles <= 0) return 0;
  if (ntiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      radix_kernel<R, N1, N2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, radix_kernel<R, N1, N2>, kRadixThreads, (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > ntiles) grid = ntiles;
  radix_kernel<R, N1, N2><<<(unsigned)grid, kRadixThreads,
                            (size_t)smem_bytes, stream>>>(
      static_cast<const cpx<R>*>(x), static_cast<cpx<R>*>(out),
      static_cast<const cpx<R>*>(consts), static_cast<const cpx<R>*>(tw),
      outer, inner, inverse, seg_log2, lines_log2, strided);
  return (int)cudaGetLastError();
}

// N = N1*N2 as transforms.factorize splits a power of two: N1 =
// 2^floor(k/2), N2 = 2^ceil(k/2).  Returns cudaErrorInvalidValue for an N
// without an instantiation (kernels/radix.py::RADIX_SIZES lists them).
template <typename R>
int radix_dispatch(int n, const void* x, void* out, const void* consts,
                   const void* tw, long long outer, long long inner,
                   int inverse, int seg_log2, int lines_log2, int strided,
                   int smem_bytes, cudaStream_t stream) {
#define REPRO_RADIX_CASE(NN, A, B)                                          \
  case NN:                                                                  \
    return radix_launch<R, A, B>(x, out, consts, tw, outer, inner, inverse, \
                                 seg_log2, lines_log2, strided, smem_bytes, \
                                 stream);
  switch (n) {
    REPRO_RADIX_CASE(4, 2, 2)
    REPRO_RADIX_CASE(8, 2, 4)
    REPRO_RADIX_CASE(16, 4, 4)
    REPRO_RADIX_CASE(32, 4, 8)
    REPRO_RADIX_CASE(64, 8, 8)
    REPRO_RADIX_CASE(128, 8, 16)
    REPRO_RADIX_CASE(256, 16, 16)
    REPRO_RADIX_CASE(512, 16, 32)
    REPRO_RADIX_CASE(1024, 32, 32)
    default:
      break;
  }
  if constexpr (sizeof(R) == sizeof(float)) {
    // complex64 only: a codelet of 64 complex128 values would need 256
    // registers, and ptxas spills the complex128 kernel of N = 2.
    switch (n) {
      REPRO_RADIX_CASE(2, 1, 2)
      REPRO_RADIX_CASE(2048, 32, 64)
      REPRO_RADIX_CASE(4096, 64, 64)
      default:
        break;
    }
  }
#undef REPRO_RADIX_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_fft
