// B1's dense route: a batched 1-D FFT of lines of any length the radix,
// long-line and split routes do not take, as a mixed-radix FFT over a
// chain chosen at run time, whole lines in shared memory.  "dense" is the
// route's name (kernels/radix.py::kernel_path), kept from the dense
// DFT-matrix kernel it replaced; the method is not dense.
//
// Replaces, for these N, the TPU kernel
// src/repro/kernels/fft_matmul.py::_fft_kernel (the pl.pallas_call in
// fft1d_planes), with its output twiddle and pack_parts epilogues.
//
// The route (kernels/dense.py::takes): every N up to the old kernel's
// one-block limit (complex64 4835, complex128 2419) that no other route
// takes -- odd N, N with a prime factor past 13, the even 13-smooth N no
// codelets of the radix or long-line route hold, the spill lengths -- and
// the 13-smooth N past it whose line and tables fit one block (complex64
// to 28431, complex128 to 14196).  The split route's general plans
// (kernels/split.py::general_factors: every other 13-smooth N past one
// block) run pass A, where N has no power-of-two P for the radix route, on
// its column form (dense_column_kernel) and pass B on its stages with the
// line's transposed store folded in (split_fold_dense_kernel), at the end
// of this file.
//
// What it computes (kernels/dense.py, whose emulate is its plain
// version): a block holds `lines` lines in shared memory and transforms
// them in place by decimation in frequency over the chain r_0, r_1, ...
// (dense_plan: the primes past 13, then 13s, 11s, 7s, 5s, 3s, 4s and a
// last 2).  Stage t, span s = r_(t+1)*r_(t+2)*..., M = r_0*...*r_(t-1):
// for every block g of r*s values and j < s, the r-point DFT of
// v[g*r*s + j + q*s], q < r, output k times W_N^(j*k*M), stored where
// input k was read.  Output X[k_0 + r_0*(k_1 + r_1*(...))] ends at
// sum_t k_t*s_t, which the store reads through two tables of ints:
// X[k] = v[PL[k mod L] + PH[k div L]].
//
// What bounds it on an H100: the function needs about 5*N*log2(N) flops
// per line against 16 bytes of complex64 moved per element, so HBM
// (3.35 TB/s) is its floor for 13-smooth N; a generic stage (a prime p
// past 13) does 8*p flops per element, which passes that floor on the
// fp32 cores (67 TFLOP/s) from p of about 20.  The dense kernel it
// replaces did 8*(N1+N2) flops per element, each with two shared-memory
// loads, and kept N1 x N1 and N2 x N2 matrices beside the tile (190 KB at
// complex64 4725, one block an SM; N x N at a prime N, streamed from L2).
//
// What the design does about it:
//  * One kernel per dtype: the chain and its tables are run-time data (a
//    switch per stage dispatches to a templated stage per radix), so no
//    length has an instantiation of its own and nvcc's time does not grow
//    with the lengths.
//  * Only the lines and small tables in shared memory: TA (2^t_log2 >=
//    sqrt(N) entries) and TB (N / 2^t_log2), W_N^e = TA[e mod T] *
//    TB[e div T], built in float64 on the host; the stage table, PL and
//    PH as ints.  About 4 KB at complex64 28028, whose line is 219 KB.
//    Short lines share a block (up to 4096 elements) and blocks share an
//    SM, so one block's loads overlap another's stages.
//  * The tile is loaded with cp.async, 8 bytes a copy for complex64 (a
//    line of odd N does not start on 16 bytes; a bulk copy needs it), 16
//    for complex128: consecutive threads copy consecutive elements, and
//    every copy of the tile is in flight before the first wait.
//  * Codelet stages (radix 2, 3, 4, 5, 7, 11, 13): each butterfly's values
//    in registers, the radix route's constant rotations (dft3, dft4, dft5;
//    dft_odd's operations for 7, 11 and 13, each output twiddled and
//    stored as soon as it is known, which keeps complex128 at about 160
//    registers without a spill).  Consecutive threads take consecutive j,
//    so a stage of span s >= 32 reads and writes consecutive addresses.
//  * A tile with the SM to itself (a line past half the shared memory)
//    runs on twice the threads, 512 for complex64 and 256 for complex128,
//    so that its stages have warps to hide their latency; the narrow
//    count lets three blocks share an SM and overlap one's loads with
//    another's stages.
//  * A generic stage: each output a p-term sum from a W_p table of p
//    entries in shared memory (O(N*p), where the dense kernel read an N x
//    N matrix for a prime N), in chunks of kGenericChunk terms for
//    accuracy at large p, into a second buffer.
//  * The store walks each line's outputs in natural order: coalesced
//    writes of the pack_parts segment (a division by its length, as on the
//    mixed routes), the output twiddle read from global memory (coalesced),
//    1/N for the inverse.
#pragma once

#include <cuda_runtime.h>

#include "fft_common.cuh"
#include "fft_long.cuh"
#include "fft_radix.cuh"

namespace repro_fft {

// Threads of one block (kernels/dense.py::DensePlan.threads): a tile that
// shares its SM with other blocks runs on kDenseNarrow* threads, one that
// has the SM alone (its shared memory past half of it) on kDenseWide*, so
// that its stages keep more warps in flight.  One kernel per dtype, bound
// for the wide block; ptxas for sm_90a gives complex64 79 registers (three
// narrow blocks an SM) and complex128 158 (three narrow blocks of 128;
// capped at 128 registers, two blocks of 256, its radix-13 butterflies
// spill).
constexpr int kDenseNarrow64 = 256;
constexpr int kDenseWide64 = 512;
constexpr int kDenseNarrow128 = 128;
constexpr int kDenseWide128 = 256;
// kernels/dense.py::GENERIC_CHUNK
constexpr int kGenericChunk = 16;

// One copy of a complex value from global to shared memory, in flight
// until dense_copy_wait.
template <typename R>
__device__ __forceinline__ void dense_copy(cpx<R>* dst, const cpx<R>* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(cpx<R>) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  }
}

// dense_copy of `src` where `valid`, else zeros (cp.async's src-size 0:
// nothing is read); `src` must be a valid address either way.
template <typename R>
__device__ __forceinline__ void dense_copy_zfill(cpx<R>* dst,
                                                 const cpx<R>* src,
                                                 bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? static_cast<int>(sizeof(cpx<R>)) : 0;
  if constexpr (sizeof(cpx<R>) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void dense_copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// W_N^e = TA[e mod T] * TB[e div T], T = 2^t_log2, for 0 <= e < N.
template <typename R>
__device__ __forceinline__ cpx<R> dense_w(const cpx<R>* __restrict__ ta,
                                          const cpx<R>* __restrict__ tb,
                                          int t_log2, int e) {
  return cmul(ta[e & ((1 << t_log2) - 1)], tb[e >> t_log2]);
}

// Where a butterfly's outputs go: output k times W_N^(jm*k) (none where
// jm = 0, and none for k = 0), stored at v[k*s].
template <typename R>
struct DenseOut {
  cpx<R>* v;
  int s, jm, t_log2;
  const cpx<R>* ta;
  const cpx<R>* tb;

  __device__ __forceinline__ void put(int k, cpx<R> y) const {
    if (jm != 0 && k != 0) y = cmul(y, dense_w(ta, tb, t_log2, jm * k));
    v[k * s] = y;
  }
};

// The P-point DFT of a with W_P = exp(s*2*pi*i/P), natural order in and
// out (kernels/radix.py::_dft_small), each output handed to `out` as soon
// as it is known.  P = 7, 11, 13 in the symmetric-pair form of dft_odd,
// the same operations in the same order, but each pair of outputs stored
// at once instead of kept in registers: the stage then holds the b_j and
// d_j and two outputs, not all P.
template <int P, typename R>
__device__ __forceinline__ void dense_dft(cpx<R> (&a)[P], R s,
                                          const DenseOut<R>& out) {
  if constexpr (P <= 5) {
    if constexpr (P == 2) {
      const cpx<R> u = a[0];
      a[0] = cadd(u, a[1]);
      a[1] = csub(u, a[1]);
    } else if constexpr (P == 3) {
      dft3(a[0], a[1], a[2], s);
    } else if constexpr (P == 4) {
      dft4(a[0], a[1], a[2], a[3], s);
    } else {
      dft5(a[0], a[1], a[2], a[3], a[4], s);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) out.put(k, a[k]);
  } else {
    constexpr int H = (P - 1) / 2;
    cpx<R> b[H], d[H];
    auto pair = [&](auto jj) {
      constexpr int j = decltype(jj)::value;
      b[j] = cadd(a[j + 1], a[P - 1 - j]);
      d[j] = csub(a[j + 1], a[P - 1 - j]);
    };
    static_for<0, H>(pair);
    cpx<R> y = a[0];
    auto sum = [&](auto jj) { y = cadd(y, b[decltype(jj)::value]); };
    static_for<0, H>(sum);
    out.put(0, y);
    auto pairs_out = [&](auto kk) {
      constexpr int k = decltype(kk)::value + 1;
      cpx<R> e = a[0], f;
      auto term = [&](auto jj) {
        constexpr int j = decltype(jj)::value;
        constexpr R kC = R(odd_cos(P, (j + 1) * k));
        constexpr R kS = R(odd_sin(P, (j + 1) * k));
        e = cadd(e, cscale(b[j], kC));
        const cpx<R> t = cscale(d[j], kS);
        if constexpr (j == 0) {
          f = t;
        } else {
          f = cadd(f, t);
        }
      };
      static_for<0, H>(term);
      f = rot(f, s);
      out.put(k, cadd(e, f));
      out.put(P - k, csub(e, f));
    };
    static_for<0, H>(pairs_out);
  }
}

// A codelet stage of radix P and span s on `nl` lines of n in place, line
// l at buf + l*pitch: butterfly i of line l is (g, j), g = its block of
// P*s values, j < s.
template <int P, typename R>
__device__ __forceinline__ void dense_stage(cpx<R>* __restrict__ buf, int n,
                                            int pitch, int nl, int s,
                                            int mul,
                                            const cpx<R>* __restrict__ ta,
                                            const cpx<R>* __restrict__ tb,
                                            int t_log2, R sgn) {
  const int nb = n / P;
  const int total = nl * nb;
  const float inv_nb = 1.0f / static_cast<float>(nb);
  const float inv_s = 1.0f / static_cast<float>(s);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int l = div_small(i, nb, inv_nb);
    const int b = i - l * nb;
    const int g = div_small(b, s, inv_s);
    const int j = b - g * s;
    cpx<R>* v = buf + l * pitch + g * (P * s) + j;
    cpx<R> a[P];
#pragma unroll
    for (int q = 0; q < P; ++q) a[q] = v[q * s];
    const DenseOut<R> out{v, s, j * mul, t_log2, ta, tb};
    dense_dft<P>(a, sgn, out);
  }
}

// A generic stage of a prime p past 13 and span s, from src into dst:
// output (g, k, j) = sum_q src[g*p*s + j + q*s] * W_p^((q*k) mod p), times
// W_N^(j*k*mul), stored at g*p*s + k*s + j.
template <typename R>
__device__ __forceinline__ void dense_generic(
    const cpx<R>* __restrict__ src, cpx<R>* __restrict__ dst, int n, int nl,
    int p, int s, int mul, const cpx<R>* __restrict__ wp,
    const cpx<R>* __restrict__ ta, const cpx<R>* __restrict__ tb,
    int t_log2) {
  const int ps = p * s;
  const int total = nl * n;
  const float inv_n = 1.0f / static_cast<float>(n);
  const float inv_ps = 1.0f / static_cast<float>(ps);
  const float inv_s = 1.0f / static_cast<float>(s);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int l = div_small(i, n, inv_n);
    const int o = i - l * n;
    const int g = div_small(o, ps, inv_ps);
    const int rem = o - g * ps;
    const int k = div_small(rem, s, inv_s);
    const int j = rem - k * s;
    const cpx<R>* v = src + l * n + g * ps + j;
    R are = R(0), aim = R(0);
    int m = 0;
    for (int q0 = 0; q0 < p; q0 += kGenericChunk) {
      const int q1 = q0 + kGenericChunk < p ? q0 + kGenericChunk : p;
      R pre = R(0), pim = R(0);
      for (int q = q0; q < q1; ++q) {
        cfma(v[q * s], wp[m], pre, pim);
        m += k;
        if (m >= p) m -= p;
      }
      are += pre;
      aim += pim;
    }
    cpx<R> y;
    y.re = are;
    y.im = aim;
    if (j != 0 && k != 0) y = cmul(y, dense_w(ta, tb, t_log2, j * k * mul));
    dst[l * n + o] = y;
  }
}

// The chain (ints: per stage radix, span, M and W_p offset) on `nl` lines
// of n in shared memory, line l at cur + l*pitch, each stage ended by a
// barrier.  With kGeneric (the dense route, lines n apart) a generic
// stage writes into `other` and the two swap; without it (the split
// route's pass A, whose P is 13-smooth) the chain holds codelets only.
// Returns the buffer that holds the result.
template <bool kGeneric, typename R>
__device__ __forceinline__ cpx<R>* dense_chain(cpx<R>* cur, cpx<R>* other,
                                               int n, int pitch, int nl,
                                               int stages,
                                               const cpx<R>* consts,
                                               const int* ints, int t_log2,
                                               int inverse) {
  const R sgn = inverse ? R(1) : R(-1);
  const cpx<R>* ta = consts;
  const cpx<R>* tb = consts + (1 << t_log2);
  for (int t = 0; t < stages; ++t) {
    const int r = ints[4 * t], s = ints[4 * t + 1], mul = ints[4 * t + 2];
    switch (r) {
      case 2:
        dense_stage<2>(cur, n, pitch, nl, s, mul, ta, tb, t_log2, sgn);
        break;
      case 3:
        dense_stage<3>(cur, n, pitch, nl, s, mul, ta, tb, t_log2, sgn);
        break;
      case 4:
        dense_stage<4>(cur, n, pitch, nl, s, mul, ta, tb, t_log2, sgn);
        break;
      case 5:
        dense_stage<5>(cur, n, pitch, nl, s, mul, ta, tb, t_log2, sgn);
        break;
      case 7:
        dense_stage<7>(cur, n, pitch, nl, s, mul, ta, tb, t_log2, sgn);
        break;
      case 11:
        dense_stage<11>(cur, n, pitch, nl, s, mul, ta, tb, t_log2, sgn);
        break;
      case 13:
        dense_stage<13>(cur, n, pitch, nl, s, mul, ta, tb, t_log2, sgn);
        break;
      default:
        if constexpr (kGeneric) {
          dense_generic(cur, other, n, nl, r, s, mul,
                        consts + ints[4 * t + 3], ta, tb, t_log2);
          cpx<R>* done = other;
          other = cur;
          cur = done;
        }
    }
    __syncthreads();
  }
  return cur;
}

// Shared memory (kernels/dense.py::DensePlan), in this order: the
// complex tables (TA, TB, the generic stages' W_p tables: n_consts
// values), the ints (per stage radix, span, M and W_p offset; then PL of
// `lo` entries and PH), each part padded to 16 bytes; from byte buf_off
// the tile of `lines` lines of n, and a second one where a generic stage
// writes.  `out` is (parts, batch, n/parts) with seg = n/parts.
//
// With kFold (the chirp route's two transforms, kernels/chirp.py), the
// line of n = M is a logical one: the load reads x's lines at pitch n_in
// (the first n_in values, cp.async's zero fill past them) and multiplies
// them by `pre` (n_in values, the input chirp) where it is given; the
// store keeps outputs k < n_out only, `out` (parts, batch, n_out/parts)
// with seg = n_out/parts.  Without it n_in = n_out = n and `pre` is
// unused, so dense_kernel keeps its SASS.
template <bool kFold, typename R>
__device__ __forceinline__ void dense_body(
    const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
    const cpx<R>* __restrict__ gconsts, const int* __restrict__ gints,
    const cpx<R>* __restrict__ tw, const cpx<R>* __restrict__ pre,
    long long batch, int n, int n_in, int n_out, int stages, int lines,
    int t_log2, int lo, int n_consts, int n_ints, int buf_off, int inverse,
    int seg) {
  extern __shared__ __align__(16) unsigned char dense_smem[];
  cpx<R>* consts = reinterpret_cast<cpx<R>*>(dense_smem);
  int* ints = reinterpret_cast<int*>(
      dense_smem +
      ((n_consts * static_cast<int>(sizeof(cpx<R>)) + 15) & ~15));
  cpx<R>* cur = reinterpret_cast<cpx<R>*>(dense_smem + buf_off);
  cpx<R>* other = cur + lines * n;

  const long long line0 = static_cast<long long>(blockIdx.x) * lines;
  const long long left = batch - line0;
  const int nl = left < lines ? static_cast<int>(left) : lines;
  const int work = nl * n;

  if constexpr (kFold) {
    // Lines n_in apart in global memory, zeros past n_in.
    const float inv_n = 1.0f / static_cast<float>(n);
    for (int i = threadIdx.x; i < work; i += blockDim.x) {
      const int l = div_small(i, n, inv_n);
      const int m = i - l * n;
      dense_copy_zfill(cur + i, x + (line0 + l) * n_in + (m < n_in ? m : 0),
                       m < n_in);
    }
  } else {
    // The tile, contiguous in global and in shared memory.
    const cpx<R>* xb = x + line0 * n;
    for (int i = threadIdx.x; i < work; i += blockDim.x)
      dense_copy(cur + i, xb + i);
  }
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x)
    consts[i] = gconsts[i];
  for (int i = threadIdx.x; i < n_ints; i += blockDim.x) ints[i] = gints[i];
  dense_copy_wait();
  __syncthreads();
  if constexpr (kFold) {
    if (pre != nullptr) {
      // the input chirp, read through L2 (every block reads the same n_in)
      const float inv_n = 1.0f / static_cast<float>(n);
#pragma unroll 4
      for (int i = threadIdx.x; i < work; i += blockDim.x) {
        const int l = div_small(i, n, inv_n);
        const int m = i - l * n;
        if (m < n_in) cur[i] = cmul(cur[i], pre[m]);
      }
      __syncthreads();
    }
  }

  cur = dense_chain<true>(cur, other, n, n, nl, stages, consts, ints, t_log2,
                         inverse);

  // The store: output k of line l from PL[k mod lo] + PH[k div lo]; with
  // kFold the outputs k < n_out.
  const int* pl = ints + 4 * stages;
  const int* ph = pl + lo;
  const R scale = inverse ? R(1) / R(n) : R(1);
  const int nk = kFold ? n_out : n;
  const float inv_n = 1.0f / static_cast<float>(nk);
  const float inv_lo = 1.0f / static_cast<float>(lo);
  const float inv_seg = 1.0f / static_cast<float>(seg);
  for (int i = threadIdx.x; i < (kFold ? nl * n_out : work);
       i += blockDim.x) {
    const int l = div_small(i, nk, inv_n);
    const int k = i - l * nk;
    const int kh = div_small(k, lo, inv_lo);
    cpx<R> v = cur[l * n + pl[k - kh * lo] + ph[kh]];
    if (tw != nullptr) v = cmul(v, tw[k]);
    v.re *= scale;
    v.im *= scale;
    const int part = div_small(k, seg, inv_seg);
    out[(static_cast<long long>(part) * batch + line0 + l) * seg + k -
        part * seg] = v;
  }
}

// One kernel per dtype, bound for its wide block (kDenseWide*).
template <typename R>
__global__ void __launch_bounds__(sizeof(R) == 4 ? kDenseWide64
                                                 : kDenseWide128, 1)
dense_kernel(const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
             const cpx<R>* __restrict__ gconsts,
             const int* __restrict__ gints, const cpx<R>* __restrict__ tw,
             long long batch, int n, int stages, int lines, int t_log2,
             int lo, int n_consts, int n_ints, int buf_off, int inverse,
             int seg) {
  dense_body<false>(x, out, gconsts, gints, tw,
                    static_cast<const cpx<R>*>(nullptr), batch, n, n, n,
                    stages, lines, t_log2, lo, n_consts, n_ints, buf_off,
                    inverse, seg);
}

// The chirp route's transforms of M = n on this kernel (dense_body's
// kFold): the first reads the N-long input lines (n_in = N, `pre` the
// input chirp, n_out = M), the second keeps the first N outputs (n_in =
// M, no `pre`, n_out = N, the pack_parts segment of N).
template <typename R>
__global__ void __launch_bounds__(sizeof(R) == 4 ? kDenseWide64
                                                 : kDenseWide128, 1)
dense_chirp_kernel(const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
                   const cpx<R>* __restrict__ gconsts,
                   const int* __restrict__ gints,
                   const cpx<R>* __restrict__ tw,
                   const cpx<R>* __restrict__ pre, long long batch, int n,
                   int n_in, int n_out, int stages, int lines, int t_log2,
                   int lo, int n_consts, int n_ints, int buf_off,
                   int inverse, int seg) {
  dense_body<true>(x, out, gconsts, gints, tw, pre, batch, n, n_in, n_out,
                   stages, lines, t_log2, lo, n_consts, n_ints, buf_off,
                   inverse, seg);
}

// Launches the dtype's kernel with `threads` (kDenseNarrow* or
// kDenseWide*) on `stream`; returns the CUDA error code (0 on success).
// The layout's numbers come from kernels/dense.py::DensePlan.
template <typename R>
int dense_launch(const void* x, void* out, const void* consts,
                 const void* ints, const void* tw, long long batch, int n,
                 int stages, int lines, int t_log2, int lo, int n_consts,
                 int n_ints, int buf_off, int inverse, int seg, int threads,
                 int smem_bytes, cudaStream_t stream) {
  if (batch <= 0) return 0;
  constexpr int kNarrow = sizeof(R) == 4 ? kDenseNarrow64 : kDenseNarrow128;
  constexpr int kWide = sizeof(R) == 4 ? kDenseWide64 : kDenseWide128;
  if (threads != kNarrow && threads != kWide)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dense_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (batch + lines - 1) / lines;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dense_kernel<R><<<static_cast<unsigned>(blocks), threads,
                    static_cast<size_t>(smem_bytes), stream>>>(
      static_cast<const cpx<R>*>(x), static_cast<cpx<R>*>(out),
      static_cast<const cpx<R>*>(consts), static_cast<const int*>(ints),
      static_cast<const cpx<R>*>(tw), batch, n, stages, lines, t_log2, lo,
      n_consts, n_ints, buf_off, inverse, seg);
  return static_cast<int>(cudaGetLastError());
}

// Launches dense_chirp_kernel: as dense_launch, the line n = M, the
// input lines n_in apart and times `pre` (null: not multiplied), the
// outputs k < n_out kept, `out` (parts, batch, n_out/parts) with seg =
// n_out/parts.
template <typename R>
int dense_chirp_launch(const void* x, void* out, const void* consts,
                       const void* ints, const void* tw, const void* pre,
                       long long batch, int n, int n_in, int n_out,
                       int stages, int lines, int t_log2, int lo,
                       int n_consts, int n_ints, int buf_off, int inverse,
                       int seg, int threads, int smem_bytes,
                       cudaStream_t stream) {
  if (batch <= 0) return 0;
  constexpr int kNarrow = sizeof(R) == 4 ? kDenseNarrow64 : kDenseNarrow128;
  constexpr int kWide = sizeof(R) == 4 ? kDenseWide64 : kDenseWide128;
  if ((threads != kNarrow && threads != kWide) || n_in < 1 || n_in > n ||
      n_out < 1 || n_out > n || seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dense_chirp_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (batch + lines - 1) / lines;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dense_chirp_kernel<R><<<static_cast<unsigned>(blocks), threads,
                          static_cast<size_t>(smem_bytes), stream>>>(
      static_cast<const cpx<R>*>(x), static_cast<cpx<R>*>(out),
      static_cast<const cpx<R>*>(consts), static_cast<const int*>(ints),
      static_cast<const cpx<R>*>(tw), static_cast<const cpx<R>*>(pre), batch,
      n, n_in, n_out, stages, lines, t_log2, lo, n_consts, n_ints, buf_off,
      inverse, seg);
  return static_cast<int>(cudaGetLastError());
}

// Pass A of the split route's general plans (kernels/split.py: a line of
// N = P*Q held as (P, Q) rows, x[p*Q + q], P any 13-smooth length this
// kernel takes, dense.column_plan): the P-long DFT of every column q of
// the (B, P, Q) block.  A block holds `lines` (a power of two) consecutive
// columns q0 + l of one line b, the tile's lines `pitch` apart (P, or
// P + 1 for an even P, so that the loads and stores of consecutive l do
// not share a bank); consecutive threads take consecutive l, so a warp
// reads and writes runs of consecutive q.  The last tile of a line may
// hold fewer than `lines` columns.  The store multiplies output kp of
// column q by the inter-step twiddle W_N^(kp*q), e = kp*q < N, from two
// tables in global memory read through L2: W_N^e = WA[e mod W] * WB[e div
// W], W = 2^w_log2 >= sqrt(N), built in float64 on the host (an N-entry
// table would be 128 MB at complex64 2^24), and writes the same (B, P, Q)
// layout, unscaled.  Pass B runs the Q-long rows on
// split_fold_dense_kernel (below).
//
// With kFold (the chirp route's first transform on a split plan of M =
// P*Q, kernels/chirp.py) the block is a logical one: line b of x holds
// n_in values at pitch n_in, index e = p*Q + q reads x[b*n_in + e] for e
// < n_in (times `pre`[e], the input chirp) and zero past it.  Without it
// dense_column_kernel keeps its SASS.
template <bool kFold, typename R>
__device__ __forceinline__ void dense_column_body(
    const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
    const cpx<R>* __restrict__ gconsts, const int* __restrict__ gints,
    const cpx<R>* __restrict__ wtab, const cpx<R>* __restrict__ pre, int n,
    int q, int n_in, int stages, int lines, int pitch, int t_log2, int lo,
    int n_consts, int n_ints, int buf_off, int inverse, int w_log2) {
  extern __shared__ __align__(16) unsigned char dense_smem[];
  cpx<R>* consts = reinterpret_cast<cpx<R>*>(dense_smem);
  int* ints = reinterpret_cast<int*>(
      dense_smem +
      ((n_consts * static_cast<int>(sizeof(cpx<R>)) + 15) & ~15));
  cpx<R>* cur = reinterpret_cast<cpx<R>*>(dense_smem + buf_off);

  // block = (line b, tile of `lines` columns); thread i holds (p, l) =
  // (i / lines, i % lines)
  const int lines_log2 = __ffs(lines) - 1;
  const int tiles = (q + lines - 1) / lines;
  const long long b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - static_cast<int>(b) * tiles) * lines;
  const int nl = q - q0 < lines ? q - q0 : lines;
  const int work = n << lines_log2;
  const long long line0 = b * n * static_cast<long long>(q) + q0;
  if constexpr (kFold) {
    const cpx<R>* xb = x + b * n_in;
    for (int i = threadIdx.x; i < work; i += blockDim.x) {
      const int l = i & (lines - 1);
      const int p = i >> lines_log2;
      const int e = p * q + q0 + l;  // < P*Q = M < 2^31
      if (l < nl)
        dense_copy_zfill(cur + l * pitch + p, xb + (e < n_in ? e : 0),
                         e < n_in);
    }
  } else {
    const cpx<R>* xb = x + line0;
    for (int i = threadIdx.x; i < work; i += blockDim.x) {
      const int l = i & (lines - 1);
      const int p = i >> lines_log2;
      if (l < nl) dense_copy(cur + l * pitch + p, xb + p * q + l);
    }
  }
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x)
    consts[i] = gconsts[i];
  for (int i = threadIdx.x; i < n_ints; i += blockDim.x) ints[i] = gints[i];
  dense_copy_wait();
  __syncthreads();
  if constexpr (kFold) {
    if (pre != nullptr) {
      // the input chirp, read through L2
#pragma unroll 4
      for (int i = threadIdx.x; i < work; i += blockDim.x) {
        const int l = i & (lines - 1);
        const int p = i >> lines_log2;
        const int e = p * q + q0 + l;
        if (l < nl && e < n_in)
          cur[l * pitch + p] = cmul(cur[l * pitch + p], pre[e]);
      }
      __syncthreads();
    }
  }

  cur = dense_chain<false>(cur, static_cast<cpx<R>*>(nullptr), n, pitch, nl,
                           stages, consts, ints, t_log2, inverse);

  // The store: output k of column l from PL[k mod lo] + PH[k div lo].
  const int* pl = ints + 4 * stages;
  const int* ph = pl + lo;
  const float inv_lo = 1.0f / static_cast<float>(lo);
  cpx<R>* ob = out + line0;
  const int wmask = (1 << w_log2) - 1;
  const cpx<R>* wb = wtab + (1 << w_log2);
  for (int i = threadIdx.x; i < work; i += blockDim.x) {
    const int l = i & (lines - 1);
    const int k = i >> lines_log2;
    if (l >= nl) continue;
    const int kh = div_small(k, lo, inv_lo);
    const cpx<R> v = cur[l * pitch + pl[k - kh * lo] + ph[kh]];
    const int e = k * (q0 + l);  // kp*q < N < 2^31
    ob[k * q + l] = cmul(v, cmul(wtab[e & wmask], wb[e >> w_log2]));
  }
}

template <typename R>
__global__ void __launch_bounds__(sizeof(R) == 4 ? kDenseWide64
                                                 : kDenseWide128, 1)
dense_column_kernel(const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
                    const cpx<R>* __restrict__ gconsts,
                    const int* __restrict__ gints,
                    const cpx<R>* __restrict__ wtab, int n, int q,
                    int stages, int lines, int pitch, int t_log2, int lo,
                    int n_consts, int n_ints, int buf_off, int inverse,
                    int w_log2) {
  dense_column_body<false>(x, out, gconsts, gints, wtab,
                           static_cast<const cpx<R>*>(nullptr), n, q, 0,
                           stages, lines, pitch, t_log2, lo, n_consts,
                           n_ints, buf_off, inverse, w_log2);
}

// dense_column_body's kFold: pass A of the chirp's first transform.
template <typename R>
__global__ void __launch_bounds__(sizeof(R) == 4 ? kDenseWide64
                                                 : kDenseWide128, 1)
dense_column_chirp_kernel(const cpx<R>* __restrict__ x,
                          cpx<R>* __restrict__ out,
                          const cpx<R>* __restrict__ gconsts,
                          const int* __restrict__ gints,
                          const cpx<R>* __restrict__ wtab,
                          const cpx<R>* __restrict__ pre, int n, int q,
                          int n_in, int stages, int lines, int pitch,
                          int t_log2, int lo, int n_consts, int n_ints,
                          int buf_off, int inverse, int w_log2) {
  dense_column_body<true>(x, out, gconsts, gints, wtab, pre, n, q, n_in,
                          stages, lines, pitch, t_log2, lo, n_consts, n_ints,
                          buf_off, inverse, w_log2);
}

// Launches pass A of a general plan (x and out (B, P, Q) blocks, batch =
// B, n = P, q = Q) with `threads` on `stream`; returns the CUDA error code
// (0 on success).  The layout's numbers come from
// kernels/dense.py::column_plan.
template <bool kFold, typename R>
int dense_column_launch_as(const void* x, void* out, const void* consts,
                           const void* ints, const void* wtab,
                           const void* pre, long long batch, int n, int q,
                           int n_in, int stages, int lines, int pitch,
                           int t_log2, int lo, int n_consts, int n_ints,
                           int buf_off, int inverse, int w_log2, int threads,
                           int smem_bytes, cudaStream_t stream) {
  if (batch <= 0) return 0;
  constexpr int kNarrow = sizeof(R) == 4 ? kDenseNarrow64 : kDenseNarrow128;
  constexpr int kWide = sizeof(R) == 4 ? kDenseWide64 : kDenseWide128;
  if ((threads != kNarrow && threads != kWide) || lines < 1 ||
      (lines & (lines - 1)) || pitch < n ||
      (kFold && (n_in < 1 || static_cast<long long>(n_in) >
                                 static_cast<long long>(n) * q)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if constexpr (kFold) {
    err = cudaFuncSetAttribute(dense_column_chirp_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
  } else {
    err = cudaFuncSetAttribute(dense_column_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = batch * ((q + lines - 1) / lines);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kFold) {
    dense_column_chirp_kernel<R><<<static_cast<unsigned>(blocks), threads,
                                   static_cast<size_t>(smem_bytes), stream>>>(
        static_cast<const cpx<R>*>(x), static_cast<cpx<R>*>(out),
        static_cast<const cpx<R>*>(consts), static_cast<const int*>(ints),
        static_cast<const cpx<R>*>(wtab), static_cast<const cpx<R>*>(pre), n,
        q, n_in, stages, lines, pitch, t_log2, lo, n_consts, n_ints, buf_off,
        inverse, w_log2);
  } else {
    dense_column_kernel<R><<<static_cast<unsigned>(blocks), threads,
                             static_cast<size_t>(smem_bytes), stream>>>(
        static_cast<const cpx<R>*>(x), static_cast<cpx<R>*>(out),
        static_cast<const cpx<R>*>(consts), static_cast<const int*>(ints),
        static_cast<const cpx<R>*>(wtab), n, q, stages, lines, pitch, t_log2,
        lo, n_consts, n_ints, buf_off, inverse, w_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches pass A of a general plan (x and out (B, P, Q) blocks, batch =
// B, n = P, q = Q) with `threads` on `stream`; returns the CUDA error code
// (0 on success).  The layout's numbers come from
// kernels/dense.py::column_plan.
template <typename R>
int dense_column_launch(const void* x, void* out, const void* consts,
                        const void* ints, const void* wtab, long long batch,
                        int n, int q, int stages, int lines, int pitch,
                        int t_log2, int lo, int n_consts, int n_ints,
                        int buf_off, int inverse, int w_log2, int threads,
                        int smem_bytes, cudaStream_t stream) {
  return dense_column_launch_as<false, R>(
      x, out, consts, ints, wtab, nullptr, batch, n, q, 0, stages, lines,
      pitch, t_log2, lo, n_consts, n_ints, buf_off, inverse, w_log2, threads,
      smem_bytes, stream);
}

// The chirp's pass A (dense_column_chirp_kernel): `x` holds B lines of
// n_in values, read as the first n_in of (B, P, Q) blocks of M = P*Q,
// times `pre`, zeros past n_in; `out` the (B, P, Q) blocks.
template <typename R>
int dense_column_chirp_launch(const void* x, void* out, const void* consts,
                              const void* ints, const void* wtab,
                              const void* pre, long long batch, int n, int q,
                              int n_in, int stages, int lines, int pitch,
                              int t_log2, int lo, int n_consts, int n_ints,
                              int buf_off, int inverse, int w_log2,
                              int threads, int smem_bytes,
                              cudaStream_t stream) {
  return dense_column_launch_as<true, R>(
      x, out, consts, ints, wtab, pre, batch, n, q, n_in, stages, lines,
      pitch, t_log2, lo, n_consts, n_ints, buf_off, inverse, w_log2, threads,
      smem_bytes, stream);
}

// Pass B of the split route on dense rows with pass C folded in
// (kernels/split.py::fold_layout; fold_emulate is its plain version): the
// general plans' rows, and a nested plan's or a chirp's M whose rows take
// the dense route, Q 13-smooth (dense_chain's codelets alone).  `y` holds
// B lines of (P, Q) rows y[b, kp, kq] (pass A's output, 16 bytes of room
// past its end), `out` (parts, B, seg), `gtw` the line's output twiddle or
// null; `scale` the inverse's 1/(P*Q); with kKeep only the outputs of <
// n_keep (the chirp's second transform: seg = n_keep/parts, `gtw` n_keep
// values).
//
// Replaces, for these rows, dense_kernel (rows in natural order) and pass
// C (split_transpose_any_kernel, split_transpose_keep_kernel: a read and a
// write of the lines more).  What bounds it: HBM, one read and one write
// of the rows.  The design: a cluster of C blocks takes a group of G = C*L
// consecutive rows of one line b (L = 2^rows_log2 rows a block, the dense
// plan's lines of Q; C = 1 where L already makes runs of 64 bytes), a
// group never spans two lines, and the grid is persistent over the
// groups.  A block's rows arrive by one bulk copy (TMA) on an mbarrier
// into a ring of `depth` slots of slot_elems values: a complex64 row may
// start 8 bytes off 16, so the copy starts at the 16 bytes below and the
// rows sit 8 bytes into the slot.  The stages run in place (dense_chain)
// and leave the rows in the chain's order (output k at PL[k mod lo] +
// PH[k div lo]).  Then (split_fold_store) each block stores its share S =
// ceil(Q/C) of kq of all the group's rows:
//  * C = 1: from its own slot;
//  * C > 1: after a cluster barrier (every block's tile free again) each
//    block pushes its rows, read in natural order from its slot, into the
//    owners' tiles (G rows of tile_pitch, an odd pitch >= S), a warp's
//    consecutive kq in one owner as consecutive remote stores; its slot is
//    then free for the group `depth` strides on, whose copy overlaps the
//    rest; after a second barrier each block stores from its own tile.
// Rows too long for a slot and a tile in one block keep pass C
// (split.fold_layout is None there): blocks that read their share from
// the other blocks' slots, whose outputs sit in the chain's digit-reversed
// order, read 7-11% slower than the three passes (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md section 6).
// The rows past P of a line's last group (a ragged P) are not copied
// (their slot's phase completes on a plain arrival) nor transformed nor
// stored.  Bound for the wide block, as dense_kernel (at three narrow
// blocks an SM ptxas spilled the complex64 kernels at 80 registers).
template <bool kKeep, typename R>
__global__ void __launch_bounds__(sizeof(R) == 4 ? kDenseWide64
                                                 : kDenseWide128, 1)
split_fold_dense_kernel(const cpx<R>* __restrict__ y,
                        cpx<R>* __restrict__ out,
                        const cpx<R>* __restrict__ gconsts,
                        const int* __restrict__ gints,
                        const cpx<R>* __restrict__ gtw, long long lines,
                        int p, int q, int stages, int rows_log2, int t_log2,
                        int lo, int n_consts, int n_ints, int buf_off,
                        int slot_elems, int depth, int tile_pitch,
                        int inverse, int seg, int n_keep, R scale) {
  extern __shared__ __align__(16) unsigned char dense_smem[];
  cpx<R>* consts = reinterpret_cast<cpx<R>*>(dense_smem);
  int* ints = reinterpret_cast<int*>(
      dense_smem +
      ((n_consts * static_cast<int>(sizeof(cpx<R>)) + 15) & ~15));
  cpx<R>* const slots = reinterpret_cast<cpx<R>*>(dense_smem + buf_off);
  const int tid = threadIdx.x;
  const unsigned csize = cluster_nctarank(), rank = cluster_ctarank();
  const int nl_max = 1 << rows_log2;
  const int g_log2 = rows_log2 + __ffs(csize) - 1;
  const int gsz = 1 << g_log2;
  cpx<R>* const tile = slots + depth * slot_elems;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(
      tile + (tile_pitch > 0 ? gsz * tile_pitch : 0));
  // groups < B*P rows < 2^31 (the launcher checks)
  const int per_line = (p + gsz - 1) / gsz;
  const int groups = (int)lines * per_line;
  const int first = blockIdx.x / csize, stride = gridDim.x / csize;
  const int share = fold_share(q, csize);
  const int kq0 = (int)rank * share < q ? (int)rank * share : q;
  const int kq1 = kq0 + share < q ? kq0 + share : q;
  // a complex64 row starting at element e of `y` sits (e & 1) values into
  // its slot
  auto head = [&](long long row) -> int {
    return sizeof(cpx<R>) == 8 ? (int)((row * q) & 1) : 0;
  };
  // One thread: group g's rows of this block into `slot`.
  auto load = [&](int g, int slot) {
    const int b = g / per_line;
    const int kp = (g - b * per_line) * gsz + (int)rank * nl_max;
    const int nl = p - kp < nl_max ? p - kp : nl_max;
    if (nl <= 0) {
      mbar_arrive(&bars[slot]);
      return;
    }
    const char* src = reinterpret_cast<const char*>(
        y + ((long long)b * p + kp) * (long long)q);
    const char* from = reinterpret_cast<const char*>(
        reinterpret_cast<unsigned long long>(src) & ~15ull);
    const unsigned bytes = (unsigned)(
        ((src - from) + (long long)nl * q * (long long)sizeof(cpx<R>) + 15) &
        ~15ll);
    bulk_load(slots + slot * slot_elems, from, bytes, &bars[slot]);
  };

  for (int i = tid; i < n_consts; i += blockDim.x) consts[i] = gconsts[i];
  for (int i = tid; i < n_ints; i += blockDim.x) ints[i] = gints[i];
  if (tid == 0) {
    for (int d = 0; d < depth; ++d) mbar_init(&bars[d], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int d = 0; d < depth; ++d)
      if (first + d * stride < groups) load(first + d * stride, d);
  }
  __syncthreads();
  const int* pl = ints + 4 * stages;
  const int* ph = pl + lo;
  const float inv_lo = 1.0f / static_cast<float>(lo);
  const float inv_q = 1.0f / static_cast<float>(q);
  const float inv_share = 1.0f / static_cast<float>(share);
  const float inv_seg = 1.0f / static_cast<float>(seg);

  int slot = 0;
  unsigned parity = 0;
  for (int g = first; g < groups; g += stride) {
    const int b = g / per_line;
    const int kp0 = (g - b * per_line) * gsz;
    const int kp = kp0 + (int)rank * nl_max;
    const int nl = p - kp < nl_max ? p - kp : nl_max;
    const int nj = p - kp0 < gsz ? p - kp0 : gsz;
    cpx<R>* const base = slots + slot * slot_elems;
    cpx<R>* const rows = base + head((long long)b * p + kp);
    mbar_wait(&bars[slot], parity);
    if (nl > 0)
      dense_chain<false>(rows, static_cast<cpx<R>*>(nullptr), q, q, nl,
                         stages, consts, ints, t_log2, inverse);
    const bool refill = g + depth * stride < groups;
    if (csize == 1) {
      split_fold_store<kKeep, 1>(
          [&](int j, int kq) {
            const int kh = div_small(kq, lo, inv_lo);
            return rows[j * q + pl[kq - kh * lo] + ph[kh]];
          },
          [&](int t) { return kq0 + t; }, kq1 - kq0, out, gtw, lines, b, p,
          kp0, g_log2, nj, seg, inv_seg, scale, n_keep);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid == 0 && refill) load(g + depth * stride, slot);
    } else {
      cluster_sync_all();  // every block's tile is free again
      for (int i = tid; i < nl * q; i += blockDim.x) {
        const int l = div_small(i, q, inv_q), kq = i - l * q;
        const int kh = div_small(kq, lo, inv_lo);
        const int o = div_small(kq, share, inv_share);
        *cluster_map(tile + ((int)rank * nl_max + l) * tile_pitch + kq -
                         o * share,
                     o) = rows[l * q + pl[kq - kh * lo] + ph[kh]];
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // the slot is read: the next copy may land in it
      if (tid == 0 && refill) load(g + depth * stride, slot);
      cluster_sync_all();  // every block's rows are in the tiles
      split_fold_store<kKeep, 1>(
          [&](int j, int kq) { return tile[j * tile_pitch + kq - kq0]; },
          [&](int t) { return kq0 + t; }, kq1 - kq0, out, gtw, lines, b, p,
          kp0, g_log2, nj, seg, inv_seg, scale, n_keep);
    }
    if (++slot == depth) {
      slot = 0;
      parity ^= 1;
    }
  }
}

// Launches split_fold_dense_kernel (kKeep where n_keep > 0) on clusters of
// `cluster` blocks of `threads` (kDenseNarrow* or kDenseWide*), a ring of
// `depth` (1 or 2) slots of slot_elems values and, where cluster > 1, the
// tile the rows are pushed into, rows tile_pitch apart; the layout's
// numbers come from kernels/split.py::fold_layout (the chain's from
// dense.dense_plan of Q).
// Returns the CUDA error code (0 on success).
template <typename R>
int split_fold_dense_launch(const void* y, void* out, const void* consts,
                            const void* ints, const void* tw,
                            long long lines, int p, int q, int stages,
                            int rows_log2, int t_log2, int lo, int n_consts,
                            int n_ints, int buf_off, int slot_elems,
                            int depth, int tile_pitch, int inverse, int seg,
                            int n_keep, int cluster, int threads,
                            int smem_bytes, cudaStream_t stream) {
  constexpr int kNarrow = sizeof(R) == 4 ? kDenseNarrow64 : kDenseNarrow128;
  constexpr int kWide = sizeof(R) == 4 ? kDenseWide64 : kDenseWide128;
  if ((threads != kNarrow && threads != kWide) || depth < 1 || depth > 2 ||
      p < 1 || q < 2 || seg < 1 || rows_log2 < 0 || rows_log2 > 11 ||
      n_keep < 0 || (long long)n_keep > (long long)p * q ||
      (long long)slot_elems * (long long)sizeof(cpx<R>) <
          ((long long)q << rows_log2) * (long long)sizeof(cpx<R>) + 16 ||
      (cluster > 1) != (tile_pitch > 0) ||
      (cluster > 1 && (depth != 1 || tile_pitch < (q + cluster - 1) / cluster)))
    return static_cast<int>(cudaErrorInvalidValue);
  // 1/(P*Q) rounded once, as the plain version's scale
  const R scale = inverse ? (R)(1.0 / ((double)p * (double)q)) : R(1);
  const long long gsz = (long long)cluster << rows_log2;
  const long long groups = lines * ((p + gsz - 1) / gsz);
  if (groups > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto args = [&](auto kernel) {
    return cluster_launch(
        kernel, threads, smem_bytes, cluster, groups, stream,
        static_cast<const cpx<R>*>(y), static_cast<cpx<R>*>(out),
        static_cast<const cpx<R>*>(consts), static_cast<const int*>(ints),
        static_cast<const cpx<R>*>(tw), lines, p, q, stages, rows_log2,
        t_log2, lo, n_consts, n_ints, buf_off, slot_elems, depth, tile_pitch,
        inverse, seg, n_keep, scale);
  };
  return n_keep > 0 ? args(split_fold_dense_kernel<true, R>)
                    : args(split_fold_dense_kernel<false, R>);
}

}  // namespace repro_fft
