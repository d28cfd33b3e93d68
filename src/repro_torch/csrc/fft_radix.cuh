// The radix path of the four-step kernel: N = N1*N2 on Hopper, with
// in-register sub-DFTs, for every even N whose only prime factors are 2, 3,
// 5, 7, 11 and 13, and every 17*2^k, 19*2^k and 23*2^k, whose factors both
// fit a codelet of 64 values (complex64) or 32 (complex128): the powers of
// two and the mixed lengths r*2^k, r from 3 to 1701
// (kernels/radix.py::RADIX_SIZES, RADIX_ODD).
//
// Replaces, for these N, the dense contractions of the TPU kernel
// src/repro/kernels/fft_matmul.py::_fft_kernel (and its twiddle and
// pack_parts epilogues), as fft_dense.cuh does for the N no codelet route
// takes.
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
//  * Mixed lengths (384 = 16*24): a codelet whose length is not a power of
//    two is a mixed-radix decimation in time over a compile-time chain of
//    radix-23, 19, 17, 13, 11, 7, 5, 3, 4 and 2 butterflies (mixed_radix),
//    loaded in digit-reversed order (load_slot); the radix-3, 4, 5, 7, 11,
//    13, 17, 19 and 23 DFTs are constant rotations with the direction's
//    sign (7 to 23 in the symmetric-pair form, dft_odd), and the inter-stage
//    twiddles come from the codelet's own table of W_L^k, k < L (N1 need
//    not divide N2, so each codelet has its table: N2 then N1 entries).
//    The row index splits by a division by the constant N1 or N2 where a
//    power of two is a shift, and the pack_parts segment (seg_arg, its
//    length for a mixed N) by a division.  The power-of-two instantiations
//    compile as before (the mixed code sits behind if constexpr).  The
//    split route's pass A stays a power of two; its pass B takes mixed Q
//    (the measured table's and split.rule_factors' rows).
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
// The split route (kernels/split.py) runs two more modes of this kernel,
// each its own instantiation (MODE), for lines longer than one block
// holds, N = P*Q:
//  * kRadixSplitA, pass A: the strided layout on the (B, P, Q) block,
//    whose store multiplies by the inter-step twiddle W_N^(kp*q) =
//    TA[kp, q % QL] * TB[kp, q / QL], two tables of P*QL and P*QH entries
//    read through L2 (not the (N,) output twiddle staged in shared
//    memory), and never scales;
//  * kRadixSplitB, pass B: contiguous rows (b, kp) of Q in, the tile laid
//    out (k1, l, m2) with a row pitch of N2 + 1, and the row pass's
//    threads along l, so that a warp stores consecutive kp of the
//    transposed output out[b, kp + P*kq]; the line's own epilogues on
//    that store: the output twiddle of P*Q entries (read through L2), the
//    inverse's 1/(P*Q) (an exact power of two; for a mixed Q the constant
//    1/Q times one, split_b_scale) and the pack_parts segment, each by the
//    line's output index (for a mixed Q a segment of any length, split by
//    div_small: the index reaches 2^24, past the plain store's fp32
//    division).
//
// kernels/radix.py holds the same plan, tiles and index maps in Python
// (radix.emulate runs them, all three modes), and the CPU tests hold them
// against np.fft.
#pragma once

#include <climits>

#include "fft_common.cuh"

namespace repro_fft {

constexpr int kRadixThreads = 256;

// What a radix kernel instantiation runs: the plain transform (lines or
// strided, chosen at run time) or one of the split route's passes.
constexpr int kRadixPlain = 0;
constexpr int kRadixSplitA = 1;
constexpr int kRadixSplitB = 2;
// The long-line route's kernels, in build_part.
constexpr int kLongMode = 3;

// The build (kernels/build.py) compiles the instantiations in
// REPRO_BUILD_PARTS translation units at once, one nvcc each: part
// build_part(n, mode, c64) instantiates the kernel of lines of n for a
// radix MODE (or kLongMode) and dtype, a hash that spreads the lengths
// evenly.  REPRO_PART = k compiles the dispatch bodies (radix_part,
// long_part) of part k; REPRO_PART = -1 leaves them out (the unit with
// the entry points, which route each length to its part); undefined, one
// unit holds everything.
#ifndef REPRO_BUILD_PARTS
#define REPRO_BUILD_PARTS 1
#endif
constexpr int kBuildParts = REPRO_BUILD_PARTS;

__host__ __device__ constexpr int build_part(int n, int mode, bool c64) {
  return (int)((((unsigned)n * 8u + (unsigned)mode * 2u + (c64 ? 1u : 0u)) *
                2654435761u) >>
               16) %
         kBuildParts;
}

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

__host__ __device__ constexpr bool is_pow2(int n) {
  return n > 0 && (n & (n - 1)) == 0;
}

// The exponent of the prime p in n.
__host__ __device__ constexpr int exponent(int n, int p) {
  int e = 0;
  while (n > 1 && n % p == 0) {
    n /= p;
    ++e;
  }
  return e;
}

// The radix of stage t (the first is t = 0) of a mixed codelet of length
// L = 2^a 3^b 5^c 7^d 11^e 13^f 17^g 19^h 23^i: the 23s, the 19s, the
// 17s, the 13s, the 11s, the 7s, the 5s, the 3s, then the 4s and a last 2
// (kernels/radix.py::radices).
__host__ __device__ constexpr int mixed_radix(int L, int t) {
  const int c23 = exponent(L, 23), c19 = c23 + exponent(L, 19);
  const int c17 = c19 + exponent(L, 17);
  const int c13 = c17 + exponent(L, 13), c11 = c13 + exponent(L, 11);
  const int c7 = c11 + exponent(L, 7), c5 = c7 + exponent(L, 5);
  const int c3 = c5 + exponent(L, 3), c4 = c3 + exponent(L, 2) / 2;
  return t < c23   ? 23
         : t < c19 ? 19
         : t < c17 ? 17
         : t < c13 ? 13
         : t < c11 ? 11
         : t < c7  ? 7
         : t < c5  ? 5
         : t < c3  ? 3
         : t < c4  ? 4
                   : 2;
}

__host__ __device__ constexpr int mixed_count(int L) {
  const int a = exponent(L, 2);
  return exponent(L, 23) + exponent(L, 19) + exponent(L, 17) +
         exponent(L, 13) + exponent(L, 11) + exponent(L, 7) + exponent(L, 5) +
         exponent(L, 3) + a / 2 + a % 2;
}

// The product of the radices of stages 0 .. t-1.
__host__ __device__ constexpr int mixed_span(int L, int t) {
  int m = 1;
  for (int i = 0; i < t; ++i) m *= mixed_radix(L, i);
  return m;
}

// The register a codelet of length L loads its input i into: bit reversal
// for a power of two; else i's digits in the chain's mixed radix, the last
// stage's least significant, each weighted by the span of the stages
// before its own (kernels/radix.py::load_slot).
__host__ __device__ constexpr int load_slot(int L, int i) {
  if (is_pow2(L)) return bitrev(i, ilog2(L));
  int p = 0;
  for (int t = mixed_count(L) - 1; t >= 0; --t) {
    const int r = mixed_radix(L, t);
    p += (i % r) * mixed_span(L, t);
    i /= r;
  }
  return p;
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

// i*s*a for the direction's sign s = +-1.
template <typename R>
__device__ __forceinline__ cpx<R> rot(cpx<R> a, R s) {
  cpx<R> r;
  r.re = -s * a.im;
  r.im = s * a.re;
  return r;
}

template <typename R>
__device__ __forceinline__ cpx<R> cscale(cpx<R> a, R k) {
  a.re *= k;
  a.im *= k;
  return a;
}

// a times w[E], or a as it is where E = 0.
template <int E, typename R>
__device__ __forceinline__ void twiddle_by(cpx<R>& a,
                                           const cpx<R>* __restrict__ w) {
  if constexpr (E != 0) a = cmul(a, w[E]);
}

// The 3-, 4- and 5-point DFTs with W_r = exp(s*2*pi*i/r), in place, as
// kernels/radix.py::_dft_small computes them: constant rotations, no table.
template <typename R>
__device__ __forceinline__ void dft3(cpx<R>& a0, cpx<R>& a1, cpx<R>& a2,
                                     R s) {
  const R kS3 = R(0.86602540378443864676);  // sin(2*pi/3)
  const cpx<R> t1 = cadd(a1, a2);
  const cpx<R> d = rot(cscale(csub(a1, a2), kS3), s);
  const cpx<R> t2 = csub(a0, cscale(t1, R(0.5)));
  a0 = cadd(a0, t1);
  a1 = cadd(t2, d);
  a2 = csub(t2, d);
}

template <typename R>
__device__ __forceinline__ void dft4(cpx<R>& a0, cpx<R>& a1, cpx<R>& a2,
                                     cpx<R>& a3, R s) {
  const cpx<R> t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const cpx<R> t2 = cadd(a1, a3), t3 = rot(csub(a1, a3), s);
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

template <typename R>
__device__ __forceinline__ void dft5(cpx<R>& a0, cpx<R>& a1, cpx<R>& a2,
                                     cpx<R>& a3, cpx<R>& a4, R s) {
  const R kC1 = R(0.30901699437494742410);   // cos(2*pi/5)
  const R kC2 = R(-0.80901699437494742410);  // cos(4*pi/5)
  const R kS1 = R(0.95105651629515357212);   // sin(2*pi/5)
  const R kS2 = R(0.58778525229247312917);   // sin(4*pi/5)
  const cpx<R> b1 = cadd(a1, a4), b2 = cadd(a2, a3);
  const cpx<R> d1 = csub(a1, a4), d2 = csub(a2, a3);
  const cpx<R> e1 = cadd(a0, cadd(cscale(b1, kC1), cscale(b2, kC2)));
  const cpx<R> e2 = cadd(a0, cadd(cscale(b1, kC2), cscale(b2, kC1)));
  const cpx<R> f1 = rot(cadd(cscale(d1, kS1), cscale(d2, kS2)), s);
  const cpx<R> f2 = rot(csub(cscale(d1, kS2), cscale(d2, kS1)), s);
  a0 = cadd(a0, cadd(b1, b2));
  a1 = cadd(e1, f1);
  a4 = csub(e1, f1);
  a2 = cadd(e2, f2);
  a3 = csub(e2, f2);
}

// cos(2*pi*m/P) and sin(2*pi*m/P) for P = 7, 11, 13, 17, 19, 23 and any
// m, from the literals of m = 1 .. (P-1)/2 by symmetry (kernels/radix.py::
// _ODD_COS and _ODD_SIN spell the same digits).  Called with constants
// only, so they fold at compile time.
__host__ __device__ constexpr double odd_cos(int p, int m) {
  m %= p;
  if (m > p / 2) m = p - m;
  if (p == 7) {
    return m == 0 ? 1.0
           : m == 1 ? 0.62348980185873353053
           : m == 2 ? -0.22252093395631440429
                    : -0.90096886790241912624;
  }
  if (p == 13) {
    return m == 0 ? 1.0
           : m == 1 ? 0.88545602565320989590
           : m == 2 ? 0.56806474673115580251
           : m == 3 ? 0.12053668025532305335
           : m == 4 ? -0.35460488704253562597
           : m == 5 ? -0.74851074817110109863
                    : -0.97094181742605202716;
  }
  if (p == 17) {
    return m == 0 ? 1.0
           : m == 1 ? 0.93247222940435580457
           : m == 2 ? 0.73900891722065911592
           : m == 3 ? 0.44573835577653826740
           : m == 4 ? 0.09226835946330199524
           : m == 5 ? -0.27366299007208286354
           : m == 6 ? -0.60263463637925638918
           : m == 7 ? -0.85021713572961415213
                    : -0.98297309968390177828;
  }
  if (p == 19) {
    return m == 0 ? 1.0
           : m == 1 ? 0.94581724170063467902
           : m == 2 ? 0.78914050939639359922
           : m == 3 ? 0.54694815812242687471
           : m == 4 ? 0.24548548714079914892
           : m == 5 ? -0.08257934547233232460
           : m == 6 ? -0.40169542465296945752
           : m == 7 ? -0.67728157162574107476
           : m == 8 ? -0.87947375120648907139
                    : -0.98636130340272237360;
  }
  if (p == 23) {
    return m == 0 ? 1.0
           : m == 1 ? 0.96291728734779929502
           : m == 2 ? 0.85441940454648855255
           : m == 3 ? 0.68255314321865408287
           : m == 4 ? 0.46006503773115212604
           : m == 5 ? 0.20345601305263378988
           : m == 6 ? -0.06824241336467097592
           : m == 7 ? -0.33487961217098615196
           : m == 8 ? -0.57668032211486714125
           : m == 9 ? -0.77571129070441980704
           : m == 10 ? -0.91721130150545301784
                     : -0.99068594603633075234;
  }
  return m == 0 ? 1.0
         : m == 1 ? 0.84125353283118116886
         : m == 2 ? 0.41541501300188642553
         : m == 3 ? -0.14231483827328514044
         : m == 4 ? -0.65486073394528506406
                  : -0.95949297361449738989;
}

__host__ __device__ constexpr double odd_sin(int p, int m) {
  m %= p;
  const double sg = m > p / 2 ? -1.0 : 1.0;
  if (m > p / 2) m = p - m;
  if (p == 7) {
    return sg * (m == 0 ? 0.0
                 : m == 1 ? 0.78183148246802980871
                 : m == 2 ? 0.97492791218182360702
                          : 0.43388373911755812048);
  }
  if (p == 13) {
    return sg * (m == 0 ? 0.0
                 : m == 1 ? 0.46472317204376854566
                 : m == 2 ? 0.82298386589365639458
                 : m == 3 ? 0.99270887409805399280
                 : m == 4 ? 0.93501624268541482344
                 : m == 5 ? 0.66312265824079520238
                          : 0.23931566428755776715);
  }
  if (p == 17) {
    return sg * (m == 0 ? 0.0
                 : m == 1 ? 0.36124166618715294874
                 : m == 2 ? 0.67369564364655721171
                 : m == 3 ? 0.89516329135506232207
                 : m == 4 ? 0.99573417629503452187
                 : m == 5 ? 0.96182564317281907041
                 : m == 6 ? 0.79801722728023950333
                 : m == 7 ? 0.52643216287735580024
                          : 0.18374951781657033157);
  }
  if (p == 19) {
    return sg * (m == 0 ? 0.0
                 : m == 1 ? 0.32469946920468348741
                 : m == 2 ? 0.61421271268966781744
                 : m == 3 ? 0.83716647826252857481
                 : m == 4 ? 0.96940026593933041674
                 : m == 5 ? 0.99658449300666984982
                 : m == 6 ? 0.91577332665505743992
                 : m == 7 ? 0.73572391067313162477
                 : m == 8 ? 0.47594739303707354443
                          : 0.16459459028073389414);
  }
  if (p == 23) {
    return sg * (m == 0 ? 0.0
                 : m == 1 ? 0.26979677115702427125
                 : m == 2 ? 0.51958395003543357813
                 : m == 3 ? 0.73083596427812410165
                 : m == 4 ? 0.88788521840237523498
                 : m == 5 ? 0.97908408768232287563
                 : m == 6 ? 0.99766876919053919845
                 : m == 7 ? 0.94226092211882049562
                 : m == 8 ? 0.81696989301044201697
                 : m == 9 ? 0.63108794432605278937
                 : m == 10 ? 0.39840108984624145800
                           : 0.13616664909624659076);
  }
  return sg * (m == 0 ? 0.0
               : m == 1 ? 0.54064081745559758211
               : m == 2 ? 0.90963199535451837141
               : m == 3 ? 0.98982144188093273238
               : m == 4 ? 0.75574957435425828377
                        : 0.28173255684142969771);
}

// The P-point DFT (P = 7, 11, 13, 17, 19, 23) of a with W_P =
// exp(s*2*pi*i/P), in place, in the symmetric-pair form
// (kernels/radix.py::_dft_odd, the same order of operations): b_j = a_j
// + a_(P-j), d_j = a_j - a_(P-j) for j < P/2; out 0 = a_0 + sum b; outs k
// and P-k = e_k +- i*s*f_k with e_k = a_0 + sum_j b_j cos(2*pi*j*k/P) and
// f_k = sum_j d_j sin(2*pi*j*k/P).
template <int P, typename R>
__device__ __forceinline__ void dft_odd(cpx<R> (&a)[P], R s) {
  constexpr int H = (P - 1) / 2;
  cpx<R> b[H], d[H];
  auto pair = [&](auto jj) {
    constexpr int j = decltype(jj)::value;
    b[j] = cadd(a[j + 1], a[P - 1 - j]);
    d[j] = csub(a[j + 1], a[P - 1 - j]);
  };
  static_for<0, H>(pair);
  const cpx<R> a0 = a[0];
  auto sum = [&](auto jj) { a[0] = cadd(a[0], b[decltype(jj)::value]); };
  static_for<0, H>(sum);
  auto out = [&](auto kk) {
    constexpr int k = decltype(kk)::value + 1;
    cpx<R> e = a0, f;
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
    a[k] = cadd(e, f);
    a[P - k] = csub(e, f);
  };
  static_for<0, H>(out);
}

// Stage T and the ones after it of a mixed codelet of length L
// (kernels/radix.py::mixed_codelet): stage T of radix r after stages
// spanning m does, for every block b of m*r and j < m, the r-point DFT of
// v[b + j + q*m], q < r, input q first multiplied by W_(m*r)^(j*q) =
// w[j*q*L/(m*r)] from the codelet's table of W_L^k, k < L.
template <int L, int T, typename R>
__device__ __forceinline__ void mixed_stages(cpx<R> (&v)[L],
                                             const cpx<R>* __restrict__ w,
                                             R s) {
  if constexpr (T < mixed_count(L)) {
    constexpr int r = mixed_radix(L, T);
    constexpr int m = mixed_span(L, T);
    constexpr int step = L / (m * r);
    auto fly = [&](auto g) {
      constexpr int j = decltype(g)::value % m;
      constexpr int i0 = (decltype(g)::value / m) * (m * r) + j;
      twiddle_by<j * step>(v[i0 + m], w);
      if constexpr (r == 2) {
        const cpx<R> u = v[i0];
        v[i0] = cadd(u, v[i0 + m]);
        v[i0 + m] = csub(u, v[i0 + m]);
      } else if constexpr (r == 3) {
        twiddle_by<2 * j * step>(v[i0 + 2 * m], w);
        dft3(v[i0], v[i0 + m], v[i0 + 2 * m], s);
      } else if constexpr (r == 4) {
        twiddle_by<2 * j * step>(v[i0 + 2 * m], w);
        twiddle_by<3 * j * step>(v[i0 + 3 * m], w);
        dft4(v[i0], v[i0 + m], v[i0 + 2 * m], v[i0 + 3 * m], s);
      } else if constexpr (r == 5) {
        twiddle_by<2 * j * step>(v[i0 + 2 * m], w);
        twiddle_by<3 * j * step>(v[i0 + 3 * m], w);
        twiddle_by<4 * j * step>(v[i0 + 4 * m], w);
        dft5(v[i0], v[i0 + m], v[i0 + 2 * m], v[i0 + 3 * m], v[i0 + 4 * m],
             s);
      } else {
        // radix 7, 11, 13, 17, 19 or 23: the inputs (input 1 twiddled
        // above) gathered into an array of constant indices, which stays
        // in registers
        static_assert(r == 7 || r == 11 || r == 13 || r == 17 || r == 19 ||
                          r == 23,
                      "the chain's radices");
        cpx<R> a[r];
        auto gather = [&](auto qq) {
          constexpr int q = decltype(qq)::value;
          a[q] = v[i0 + q * m];
          if constexpr (q >= 2) twiddle_by<q * j * step>(a[q], w);
        };
        static_for<0, r>(gather);
        dft_odd<r>(a, s);
        auto scatter = [&](auto qq) {
          constexpr int q = decltype(qq)::value;
          v[i0 + q * m] = a[q];
        };
        static_for<0, r>(scatter);
      }
    };
    static_for<0, L / r>(fly);
    mixed_stages<L, T + 1, R>(v, w, s);
  }
}

// A codelet of length L on v, loaded in load_slot order; natural order out.
// A power of two runs the radix-2 stages with w[k] = W_WL^k, k < WL/2;
// any other length the mixed stages with w[k] = W_L^k, k < L, and the
// direction's sign s.
template <int L, int WL, typename R>
__device__ __forceinline__ void codelet(cpx<R> (&v)[L],
                                        const cpx<R>* __restrict__ w, R s) {
  if constexpr (is_pow2(L)) {
    fft_stages<L, WL, 2, R>(v, w);
  } else {
    mixed_stages<L, 0, R>(v, w, s);
  }
}

// 2^-e as an R, exactly (0 <= e < 127): the split's 1/(P*Q) without a
// run-time division.
template <typename R>
__device__ __forceinline__ R pow2_neg(int e) {
  if constexpr (sizeof(R) == sizeof(float)) {
    return __int_as_float((127 - e) << 23);
  } else {
    return __longlong_as_double((long long)(1023 - e) << 52);
  }
}

// Pass B's scale, its line's 1/(P*Q) with P = 2^p_log2: an exact power of
// two for a power-of-two Q, else the constant 1/Q times 2^-p_log2.
template <typename R, int Q>
__device__ __forceinline__ R split_b_scale(int p_log2) {
  if constexpr (is_pow2(Q)) {
    return pow2_neg<R>(ilog2(Q) + p_log2);
  } else {
    constexpr R kInvQ = R(1) / R(Q);
    return kInvQ * pow2_neg<R>(p_log2);
  }
}

// q / d for 0 <= q < 2^24 and a quotient below 2^20: an fp32 estimate of
// q * (1/d), off by at most one, corrected in integers (no division).
__device__ __forceinline__ int div_small(int q, int d, float inv_d) {
  int r = __float2int_rz((float)q * inv_d);
  const int rem = q - r * d;
  r += (rem >= d) - (rem < 0);
  return r;
}

// Shared memory, in this order: T (N), the codelet tables (N2/2 shared
// for a power of two; else N2 for the rows, then N1 for the columns), the
// output twiddle (N, when tw is given, kRadixPlain only) and the tile;
// the wrapper sizes it (kernels/radix.py::radix_tile).  `out` is (parts,
// outer, N/parts) for contiguous lines, with seg_arg = log2(N/parts) for
// a power-of-two N and seg_arg = N/parts for a mixed N (the one argument
// keeps the power-of-two kernels' parameters as they were); or (outer, N,
// inner) when `strided`.  The split passes: kRadixSplitA takes
// the (B, P, Q) block as (outer, N, inner) with `gtw` the TA|TB tables
// and aux_log2 = log2(QL); kRadixSplitB takes outer = B*P rows of N = Q
// with `gtw` the line's output twiddle (P*Q entries, or null), aux_log2 =
// log2(P), and `out` (parts, B, P*Q/parts) with seg_arg = log2(P*Q/parts)
// for a power-of-two Q, P*Q/parts for a mixed Q.
template <typename R, int N1, int N2, int MODE>
__global__ void __launch_bounds__(kRadixThreads)
radix_kernel(const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
             const cpx<R>* __restrict__ consts,
             const cpx<R>* __restrict__ gtw, long long outer,
             long long inner, int inverse, int seg_arg, int lines_log2,
             int strided_arg, int aux_log2) {
  constexpr int N = N1 * N2;
  constexpr bool kPow2 = is_pow2(N);
  static_assert(kPow2 || MODE != kRadixSplitA,
                "the split route's pass A takes powers of two");
  // the codelet tables: N2/2 shared, or the rows' N2 then the columns' N1
  constexpr int NW = kPow2 ? N2 / 2 : N2 + N1;
  constexpr int B1 = ilog2(N1);
  constexpr int B2 = ilog2(N2);
  constexpr bool kSplitA = MODE == kRadixSplitA;
  constexpr bool kSplitB = MODE == kRadixSplitB;
  constexpr bool kStageTw = MODE == kRadixPlain;
  // The flags stay ints and the scale below one const expression, as the
  // plain kernel had them: with a bool flag and a scale assigned under an
  // `if`, ptxas spilled 8 bytes in the plain complex128 2x4 instantiation.
  const int strided = kSplitA ? 1 : (kSplitB ? 0 : strided_arg);
  // pass B's row pass runs its threads along the line, as strided does
  const int line_fast = kSplitB ? 1 : strided;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cpx<R>* const st = reinterpret_cast<cpx<R>*>(smem_raw);
  cpx<R>* const sw = st + N;
  cpx<R>* const stw = sw + NW;
  cpx<R>* const tile = stw + (kStageTw && gtw != nullptr ? N : 0);
  const cpx<R>* const sw1 = kPow2 ? sw : sw + N2;  // the column codelet's
  const R sgn = inverse ? R(1) : R(-1);  // the mixed codelets' rotations

  for (int i = threadIdx.x; i < N + NW; i += kRadixThreads) st[i] = consts[i];
  if (kStageTw && gtw != nullptr)
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
  // pass B's tile is (k1, l, m2), pitch N2 + 1: the column pass's stores
  // (along m2) and the row pass's reads (along l, then k1) both hit
  // distinct banks.
  const int sl = strided ? 1 : (kSplitB ? N2 + 1 : N1 * (N2 + 1));
  const int sr = strided ? N2 * L : (kSplitB ? L * (N2 + 1) : N2 + 1);
  const int sc = strided ? L : 1;
  const long long js = strided ? inner : 1;
  // 1/N folded at compile time: a run-time double division would call a
  // subroutine that needs a stack frame.  Pass A never scales; pass B
  // scales by the whole line's 1/(P*Q), once.
  constexpr R kInvN = R(1) / R(N);
  const R scale =
      kSplitB ? (inverse ? split_b_scale<R, N>(aux_log2) : R(1))
              : (kSplitA ? R(1) : (inverse ? kInvN : R(1)));
  // the power-of-two kernels' segment by its log2; a mixed N's (pass B:
  // its line's) by length
  const int seg_log2 = seg_arg;
  const int seg = 1 << seg_log2;
  const float inv_seg = __fdividef(1.0f, (float)seg_arg);  // mixed N

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
        if constexpr (kPow2) {
          l = c >> B2;
          m2 = c & (N2 - 1);
        } else {
          l = c / N2;
          m2 = c - l * N2;
        }
      }
      const long long line = first + l;
      if (line >= nlines) continue;
      const long long base = strided ? block_base + line : line * N;
      const cpx<R>* src = x + base + m2 * js;
      cpx<R> v[N1];
      auto load = [&](auto i) {
        constexpr int m1 = decltype(i)::value;
        constexpr int slot = load_slot(N1, m1);
        v[slot] = src[(long long)(m1 * N2) * js];
      };
      static_for<0, N1>(load);
      codelet<N1, (kPow2 ? N2 : N1), R>(v, sw1, sgn);
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
      if (line_fast) {
        l = r & (L - 1);
        k1 = r >> lines_log2;
      } else {
        if constexpr (kPow2) {
          l = r >> B1;
          k1 = r & (N1 - 1);
        } else {
          l = r / N1;
          k1 = r - l * N1;
        }
      }
      const long long line = first + l;
      if (line >= nlines) continue;
      const cpx<R>* srow = tile + l * sl + k1 * sr;
      cpx<R> v[N2];
      auto load = [&](auto i) {
        constexpr int m2 = decltype(i)::value;
        constexpr int slot = load_slot(N2, m2);
        v[slot] = srow[m2 * sc];
      };
      static_for<0, N2>(load);
      codelet<N2, N2, R>(v, sw, sgn);
      if constexpr (kSplitA) {
        // W_N^(o*q) for column q = line: TA[o, q % QL] * TB[o, q / QL]
        const int q = (int)line;
        const int ql = 1 << aux_log2;
        const int qh = (int)(inner >> aux_log2);
        const cpx<R>* const ta = gtw + (q & (ql - 1));
        const cpx<R>* const tb = gtw + N * ql + (q >> aux_log2);
        auto store = [&](auto i) {
          constexpr int k2 = decltype(i)::value;
          const int o = k1 + N1 * k2;
          out[block_base + line + (long long)o * inner] =
              cmul(v[k2], cmul(ta[o * ql], tb[o * qh]));
        };
        static_for<0, N2>(store);
      } else if constexpr (kSplitB && kPow2) {
        // row (b, kp) of a line of P*Q: its output kq lands at the line's
        // index kp + P*kq
        const int kp = (int)(line & ((1 << aux_log2) - 1));
        const long long base = (line >> aux_log2) << seg_log2;
        const long long plane = (outer >> aux_log2) << seg_log2;
        auto store = [&](auto i) {
          constexpr int k2 = decltype(i)::value;
          const int of = kp + ((k1 + N1 * k2) << aux_log2);
          cpx<R> y = v[k2];
          if (gtw != nullptr) y = cmul(y, gtw[of]);
          y.re *= scale;
          y.im *= scale;
          out[base + (long long)(of >> seg_log2) * plane + (of & (seg - 1))] =
              y;
        };
        static_for<0, N2>(store);
      } else if constexpr (kSplitB) {
        // a mixed Q: the line's index kp + P*kq is below 2^24, and its
        // segment (seg_arg, any length) splits it by div_small
        const int kp = (int)(line & ((1 << aux_log2) - 1));
        const long long b = line >> aux_log2;
        const long long nb = outer >> aux_log2;
        auto store = [&](auto i) {
          constexpr int k2 = decltype(i)::value;
          const int of = kp + ((k1 + N1 * k2) << aux_log2);
          cpx<R> y = v[k2];
          if (gtw != nullptr) y = cmul(y, gtw[of]);
          y.re *= scale;
          y.im *= scale;
          const int part = div_small(of, seg_arg, inv_seg);
          out[(part * nb + b) * seg_arg + (of - part * seg_arg)] = y;
        };
        static_for<0, N2>(store);
      } else {
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
            if constexpr (kPow2) {
              addr = (((long long)(o >> seg_log2) * outer + line)
                      << seg_log2) +
                     (o & (seg - 1));
            } else {
              // part = o / seg_arg in fp32: exact, as o + 1/2 is at least
              // 1/2 from a multiple of seg_arg and the quotient's rounding
              // error stays under 2^-20 of it.  An integer division per
              // store took 23% more time at (262144, 384); a branch for
              // seg_arg == N made ptxas spill at 12x16 and 15x16.
              const int part = __float2int_rz(((float)o + 0.5f) * inv_seg);
              addr = ((long long)part * outer + line) * seg_arg +
                     (o - part * seg_arg);
            }
          }
          out[addr] = y;
        };
        static_for<0, N2>(store);
      }
    }
    __syncthreads();  // the next tile's column pass overwrites the tile
  }
}

template <typename R, int N1, int N2, int MODE>
int radix_launch(const void* x, void* out, const void* consts,
                 const void* tw, long long outer, long long inner,
                 int inverse, int seg_arg, int lines_log2, int strided,
                 int aux_log2, int smem_bytes, cudaStream_t stream) {
  const long long lines = 1LL << lines_log2;
  const long long ntiles = strided ? outer * ((inner + lines - 1) / lines)
                                   : (outer + lines - 1) / lines;
  if (ntiles <= 0) return 0;
  if (ntiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      radix_kernel<R, N1, N2, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, radix_kernel<R, N1, N2, MODE>, kRadixThreads,
      (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > ntiles) grid = ntiles;
  radix_kernel<R, N1, N2, MODE><<<(unsigned)grid, kRadixThreads,
                                  (size_t)smem_bytes, stream>>>(
      static_cast<const cpx<R>*>(x), static_cast<cpx<R>*>(out),
      static_cast<const cpx<R>*>(consts), static_cast<const cpx<R>*>(tw),
      outer, inner, inverse, seg_arg, lines_log2, strided, aux_log2);
  return (int)cudaGetLastError();
}

// N = N1*N2 as transforms.factorize splits it: for a power of two N1 =
// 2^floor(k/2), N2 = 2^ceil(k/2).  Launches the lengths of build part PART
// (build_part); returns cudaErrorInvalidValue for an N without an
// instantiation of MODE in that part: kernels/radix.py::RADIX_SIZES lists
// the plain ones, kernels/split.py::COLUMN_SIZES (pass A) and ROW_SIZES
// (pass B) the split route's.
template <typename R, int MODE, int PART>
int radix_part(int n, const void* x, void* out, const void* consts,
               const void* tw, long long outer, long long inner, int inverse,
               int seg_arg, int lines_log2, int strided, int aux_log2,
               int smem_bytes, cudaStream_t stream);

#if !defined(REPRO_PART) || REPRO_PART >= 0
template <typename R, int MODE, int PART>
int radix_part(int n, const void* x, void* out, const void* consts,
               const void* tw, long long outer, long long inner, int inverse,
               int seg_arg, int lines_log2, int strided, int aux_log2,
               int smem_bytes, cudaStream_t stream) {
#define REPRO_RADIX_CASE(NN, A, B)                                          \
  case NN:                                                                  \
    if constexpr (build_part(NN, MODE, c64) == PART)                        \
      return radix_launch<R, A, B, MODE>(x, out, consts, tw, outer, inner,  \
                                         inverse, seg_arg, lines_log2,      \
                                         strided, aux_log2, smem_bytes,     \
                                         stream);                           \
    break;
  constexpr bool c64 = sizeof(R) == sizeof(float);
  if constexpr (MODE == kRadixPlain) {
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
      // the mixed lengths whose codelets are at most 32 long
      REPRO_RADIX_CASE(6, 2, 3)
      REPRO_RADIX_CASE(10, 2, 5)
      REPRO_RADIX_CASE(12, 3, 4)
      REPRO_RADIX_CASE(18, 3, 6)
      REPRO_RADIX_CASE(20, 4, 5)
      REPRO_RADIX_CASE(24, 4, 6)
      REPRO_RADIX_CASE(30, 5, 6)
      REPRO_RADIX_CASE(36, 6, 6)
      REPRO_RADIX_CASE(40, 5, 8)
      REPRO_RADIX_CASE(48, 6, 8)
      REPRO_RADIX_CASE(60, 6, 10)
      REPRO_RADIX_CASE(72, 8, 9)
      REPRO_RADIX_CASE(80, 8, 10)
      REPRO_RADIX_CASE(96, 8, 12)
      REPRO_RADIX_CASE(120, 10, 12)
      REPRO_RADIX_CASE(144, 12, 12)
      REPRO_RADIX_CASE(160, 10, 16)
      REPRO_RADIX_CASE(192, 12, 16)
      REPRO_RADIX_CASE(240, 15, 16)
      REPRO_RADIX_CASE(288, 16, 18)
      REPRO_RADIX_CASE(320, 16, 20)
      REPRO_RADIX_CASE(384, 16, 24)
      REPRO_RADIX_CASE(480, 20, 24)
      REPRO_RADIX_CASE(576, 24, 24)
      REPRO_RADIX_CASE(640, 20, 32)
      REPRO_RADIX_CASE(768, 24, 32)
      REPRO_RADIX_CASE(960, 30, 32)
      // 7*2^k and 11*2^k
      REPRO_RADIX_CASE(14, 2, 7)
      REPRO_RADIX_CASE(28, 4, 7)
      REPRO_RADIX_CASE(56, 7, 8)
      REPRO_RADIX_CASE(112, 8, 14)
      REPRO_RADIX_CASE(224, 14, 16)
      REPRO_RADIX_CASE(448, 16, 28)
      REPRO_RADIX_CASE(896, 28, 32)
      REPRO_RADIX_CASE(44, 4, 11)
      REPRO_RADIX_CASE(88, 8, 11)
      REPRO_RADIX_CASE(176, 11, 16)
      REPRO_RADIX_CASE(352, 16, 22)
      REPRO_RADIX_CASE(704, 22, 32)
      // 13*2^k
      REPRO_RADIX_CASE(26, 2, 13)
      REPRO_RADIX_CASE(52, 4, 13)
      REPRO_RADIX_CASE(104, 8, 13)
      REPRO_RADIX_CASE(416, 16, 26)
      REPRO_RADIX_CASE(832, 26, 32)
      // the odd products r*2^k, r = 21, 25, 27, 33, 35, 39, 45, 49, 55
      // and 63: one codelet each (42 = 6x7, 864 = 27x32)
      REPRO_RADIX_CASE(42, 6, 7)
      REPRO_RADIX_CASE(50, 5, 10)
      REPRO_RADIX_CASE(54, 6, 9)
      REPRO_RADIX_CASE(66, 6, 11)
      REPRO_RADIX_CASE(70, 7, 10)
      REPRO_RADIX_CASE(78, 6, 13)
      REPRO_RADIX_CASE(84, 7, 12)
      REPRO_RADIX_CASE(90, 9, 10)
      REPRO_RADIX_CASE(98, 7, 14)
      REPRO_RADIX_CASE(100, 10, 10)
      REPRO_RADIX_CASE(108, 9, 12)
      REPRO_RADIX_CASE(110, 10, 11)
      REPRO_RADIX_CASE(126, 9, 14)
      REPRO_RADIX_CASE(132, 11, 12)
      REPRO_RADIX_CASE(140, 10, 14)
      REPRO_RADIX_CASE(156, 12, 13)
      REPRO_RADIX_CASE(168, 12, 14)
      REPRO_RADIX_CASE(180, 12, 15)
      REPRO_RADIX_CASE(196, 14, 14)
      REPRO_RADIX_CASE(200, 10, 20)
      REPRO_RADIX_CASE(216, 12, 18)
      REPRO_RADIX_CASE(220, 11, 20)
      REPRO_RADIX_CASE(252, 14, 18)
      REPRO_RADIX_CASE(264, 12, 22)
      REPRO_RADIX_CASE(280, 14, 20)
      REPRO_RADIX_CASE(312, 13, 24)
      REPRO_RADIX_CASE(336, 16, 21)
      REPRO_RADIX_CASE(360, 18, 20)
      REPRO_RADIX_CASE(392, 14, 28)
      REPRO_RADIX_CASE(400, 20, 20)
      REPRO_RADIX_CASE(432, 18, 24)
      REPRO_RADIX_CASE(440, 20, 22)
      REPRO_RADIX_CASE(528, 22, 24)
      REPRO_RADIX_CASE(560, 20, 28)
      REPRO_RADIX_CASE(624, 24, 26)
      REPRO_RADIX_CASE(672, 24, 28)
      REPRO_RADIX_CASE(720, 24, 30)
      REPRO_RADIX_CASE(784, 28, 28)
      REPRO_RADIX_CASE(800, 25, 32)
      REPRO_RADIX_CASE(864, 27, 32)
      // the odd parts from 65: every other even 13-smooth N whose factors
      // both fit a codelet of 32 (130 = 10x13, 600 = 24x25, 900 = 30x30)
      REPRO_RADIX_CASE(130, 10, 13)
      REPRO_RADIX_CASE(150, 10, 15)
      REPRO_RADIX_CASE(154, 11, 14)
      REPRO_RADIX_CASE(162, 9, 18)
      REPRO_RADIX_CASE(182, 13, 14)
      REPRO_RADIX_CASE(198, 11, 18)
      REPRO_RADIX_CASE(210, 14, 15)
      REPRO_RADIX_CASE(234, 13, 18)
      REPRO_RADIX_CASE(242, 11, 22)
      REPRO_RADIX_CASE(250, 10, 25)
      REPRO_RADIX_CASE(260, 13, 20)
      REPRO_RADIX_CASE(270, 15, 18)
      REPRO_RADIX_CASE(286, 13, 22)
      REPRO_RADIX_CASE(294, 14, 21)
      REPRO_RADIX_CASE(300, 15, 20)
      REPRO_RADIX_CASE(308, 14, 22)
      REPRO_RADIX_CASE(324, 18, 18)
      REPRO_RADIX_CASE(330, 15, 22)
      REPRO_RADIX_CASE(338, 13, 26)
      REPRO_RADIX_CASE(350, 14, 25)
      REPRO_RADIX_CASE(364, 14, 26)
      REPRO_RADIX_CASE(378, 18, 21)
      REPRO_RADIX_CASE(390, 15, 26)
      REPRO_RADIX_CASE(396, 18, 22)
      REPRO_RADIX_CASE(420, 20, 21)
      REPRO_RADIX_CASE(450, 18, 25)
      REPRO_RADIX_CASE(462, 21, 22)
      REPRO_RADIX_CASE(468, 18, 26)
      REPRO_RADIX_CASE(484, 22, 22)
      REPRO_RADIX_CASE(486, 18, 27)
      REPRO_RADIX_CASE(500, 20, 25)
      REPRO_RADIX_CASE(520, 20, 26)
      REPRO_RADIX_CASE(540, 20, 27)
      REPRO_RADIX_CASE(546, 21, 26)
      REPRO_RADIX_CASE(550, 22, 25)
      REPRO_RADIX_CASE(572, 22, 26)
      REPRO_RADIX_CASE(588, 21, 28)
      REPRO_RADIX_CASE(594, 22, 27)
      REPRO_RADIX_CASE(600, 24, 25)
      REPRO_RADIX_CASE(616, 22, 28)
      REPRO_RADIX_CASE(630, 21, 30)
      REPRO_RADIX_CASE(648, 24, 27)
      REPRO_RADIX_CASE(650, 25, 26)
      REPRO_RADIX_CASE(660, 22, 30)
      REPRO_RADIX_CASE(676, 26, 26)
      REPRO_RADIX_CASE(700, 25, 28)
      REPRO_RADIX_CASE(702, 26, 27)
      REPRO_RADIX_CASE(728, 26, 28)
      REPRO_RADIX_CASE(750, 25, 30)
      REPRO_RADIX_CASE(756, 27, 28)
      REPRO_RADIX_CASE(780, 26, 30)
      REPRO_RADIX_CASE(810, 27, 30)
      REPRO_RADIX_CASE(840, 28, 30)
      REPRO_RADIX_CASE(900, 30, 30)
      // 17*2^k and 19*2^k
      REPRO_RADIX_CASE(34, 2, 17)
      REPRO_RADIX_CASE(68, 4, 17)
      REPRO_RADIX_CASE(136, 8, 17)
      REPRO_RADIX_CASE(272, 16, 17)
      REPRO_RADIX_CASE(544, 17, 32)
      REPRO_RADIX_CASE(38, 2, 19)
      REPRO_RADIX_CASE(76, 4, 19)
      REPRO_RADIX_CASE(152, 8, 19)
      REPRO_RADIX_CASE(304, 16, 19)
      REPRO_RADIX_CASE(608, 19, 32)
      // 23*2^k
      REPRO_RADIX_CASE(46, 2, 23)
      REPRO_RADIX_CASE(92, 4, 23)
      REPRO_RADIX_CASE(184, 8, 23)
      REPRO_RADIX_CASE(368, 16, 23)
      REPRO_RADIX_CASE(736, 23, 32)
      default:
        break;
    }
    if constexpr (c64) {
      // complex64 only: a codelet of 64 complex128 values would need 256
      // registers, and ptxas spills the complex128 kernels of N = 2 and
      // N = 22 = 2x11 (4 bytes each).
      switch (n) {
        REPRO_RADIX_CASE(2, 1, 2)
        REPRO_RADIX_CASE(22, 2, 11)
        REPRO_RADIX_CASE(2048, 32, 64)
        REPRO_RADIX_CASE(4096, 64, 64)
        REPRO_RADIX_CASE(1152, 32, 36)
        REPRO_RADIX_CASE(1280, 32, 40)
        REPRO_RADIX_CASE(1536, 32, 48)
        REPRO_RADIX_CASE(1920, 40, 48)
        REPRO_RADIX_CASE(2304, 48, 48)
        REPRO_RADIX_CASE(2560, 40, 64)
        REPRO_RADIX_CASE(3072, 48, 64)
        REPRO_RADIX_CASE(3840, 60, 64)
        REPRO_RADIX_CASE(1408, 32, 44)
        REPRO_RADIX_CASE(1792, 32, 56)
        REPRO_RADIX_CASE(2816, 44, 64)
        REPRO_RADIX_CASE(3584, 56, 64)
        REPRO_RADIX_CASE(1664, 32, 52)
        REPRO_RADIX_CASE(3328, 52, 64)
        // the odd products (1056 = 32x33, 4032 = 63x64)
        REPRO_RADIX_CASE(880, 22, 40)
        REPRO_RADIX_CASE(1008, 28, 36)
        REPRO_RADIX_CASE(1056, 32, 33)
        REPRO_RADIX_CASE(1120, 32, 35)
        REPRO_RADIX_CASE(1248, 32, 39)
        REPRO_RADIX_CASE(1344, 32, 42)
        REPRO_RADIX_CASE(1440, 36, 40)
        REPRO_RADIX_CASE(1568, 32, 49)
        REPRO_RADIX_CASE(1600, 40, 40)
        REPRO_RADIX_CASE(1728, 36, 48)
        REPRO_RADIX_CASE(1760, 40, 44)
        REPRO_RADIX_CASE(2016, 42, 48)
        REPRO_RADIX_CASE(2112, 44, 48)
        REPRO_RADIX_CASE(2240, 40, 56)
        REPRO_RADIX_CASE(2496, 48, 52)
        REPRO_RADIX_CASE(2688, 48, 56)
        REPRO_RADIX_CASE(2880, 48, 60)
        REPRO_RADIX_CASE(3136, 56, 56)
        REPRO_RADIX_CASE(3200, 50, 64)
        REPRO_RADIX_CASE(3456, 54, 64)
        REPRO_RADIX_CASE(3520, 55, 64)
        REPRO_RADIX_CASE(4032, 63, 64)
        // the odd parts from 65 with a factor of 33 to 64 (490 = 14x35,
        // 3600 = 60x60, 3780 = 60x63)
        REPRO_RADIX_CASE(490, 14, 35)
        REPRO_RADIX_CASE(686, 14, 49)
        REPRO_RADIX_CASE(726, 22, 33)
        REPRO_RADIX_CASE(770, 22, 35)
        REPRO_RADIX_CASE(792, 24, 33)
        REPRO_RADIX_CASE(858, 26, 33)
        REPRO_RADIX_CASE(882, 21, 42)
        REPRO_RADIX_CASE(910, 26, 35)
        REPRO_RADIX_CASE(924, 28, 33)
        REPRO_RADIX_CASE(936, 26, 36)
        REPRO_RADIX_CASE(968, 22, 44)
        REPRO_RADIX_CASE(972, 27, 36)
        REPRO_RADIX_CASE(980, 28, 35)
        REPRO_RADIX_CASE(990, 30, 33)
        REPRO_RADIX_CASE(1000, 25, 40)
        REPRO_RADIX_CASE(1014, 26, 39)
        REPRO_RADIX_CASE(1040, 26, 40)
        REPRO_RADIX_CASE(1050, 30, 35)
        REPRO_RADIX_CASE(1078, 22, 49)
        REPRO_RADIX_CASE(1080, 30, 36)
        REPRO_RADIX_CASE(1092, 28, 39)
        REPRO_RADIX_CASE(1100, 25, 44)
        REPRO_RADIX_CASE(1134, 27, 42)
        REPRO_RADIX_CASE(1144, 26, 44)
        REPRO_RADIX_CASE(1170, 30, 39)
        REPRO_RADIX_CASE(1176, 28, 42)
        REPRO_RADIX_CASE(1188, 33, 36)
        REPRO_RADIX_CASE(1200, 30, 40)
        REPRO_RADIX_CASE(1210, 22, 55)
        REPRO_RADIX_CASE(1232, 28, 44)
        REPRO_RADIX_CASE(1250, 25, 50)
        REPRO_RADIX_CASE(1260, 35, 36)
        REPRO_RADIX_CASE(1274, 26, 49)
        REPRO_RADIX_CASE(1296, 36, 36)
        REPRO_RADIX_CASE(1300, 26, 50)
        REPRO_RADIX_CASE(1320, 33, 40)
        REPRO_RADIX_CASE(1350, 30, 45)
        REPRO_RADIX_CASE(1352, 26, 52)
        REPRO_RADIX_CASE(1372, 28, 49)
        REPRO_RADIX_CASE(1386, 33, 42)
        REPRO_RADIX_CASE(1400, 35, 40)
        REPRO_RADIX_CASE(1404, 36, 39)
        REPRO_RADIX_CASE(1430, 26, 55)
        REPRO_RADIX_CASE(1452, 33, 44)
        REPRO_RADIX_CASE(1456, 28, 52)
        REPRO_RADIX_CASE(1458, 27, 54)
        REPRO_RADIX_CASE(1470, 35, 42)
        REPRO_RADIX_CASE(1500, 30, 50)
        REPRO_RADIX_CASE(1512, 36, 42)
        REPRO_RADIX_CASE(1540, 35, 44)
        REPRO_RADIX_CASE(1560, 39, 40)
        REPRO_RADIX_CASE(1584, 36, 44)
        REPRO_RADIX_CASE(1620, 36, 45)
        REPRO_RADIX_CASE(1638, 39, 42)
        REPRO_RADIX_CASE(1650, 33, 50)
        REPRO_RADIX_CASE(1680, 40, 42)
        REPRO_RADIX_CASE(1716, 39, 44)
        REPRO_RADIX_CASE(1750, 35, 50)
        REPRO_RADIX_CASE(1764, 42, 42)
        REPRO_RADIX_CASE(1782, 33, 54)
        REPRO_RADIX_CASE(1800, 40, 45)
        REPRO_RADIX_CASE(1820, 35, 52)
        REPRO_RADIX_CASE(1848, 42, 44)
        REPRO_RADIX_CASE(1872, 39, 48)
        REPRO_RADIX_CASE(1890, 42, 45)
        REPRO_RADIX_CASE(1936, 44, 44)
        REPRO_RADIX_CASE(1944, 36, 54)
        REPRO_RADIX_CASE(1950, 39, 50)
        REPRO_RADIX_CASE(1960, 40, 49)
        REPRO_RADIX_CASE(1980, 44, 45)
        REPRO_RADIX_CASE(2000, 40, 50)
        REPRO_RADIX_CASE(2028, 39, 52)
        REPRO_RADIX_CASE(2058, 42, 49)
        REPRO_RADIX_CASE(2080, 40, 52)
        REPRO_RADIX_CASE(2100, 42, 50)
        REPRO_RADIX_CASE(2106, 39, 54)
        REPRO_RADIX_CASE(2156, 44, 49)
        REPRO_RADIX_CASE(2160, 45, 48)
        REPRO_RADIX_CASE(2184, 42, 52)
        REPRO_RADIX_CASE(2200, 44, 50)
        REPRO_RADIX_CASE(2250, 45, 50)
        REPRO_RADIX_CASE(2268, 42, 54)
        REPRO_RADIX_CASE(2288, 44, 52)
        REPRO_RADIX_CASE(2310, 42, 55)
        REPRO_RADIX_CASE(2340, 45, 52)
        REPRO_RADIX_CASE(2352, 48, 49)
        REPRO_RADIX_CASE(2376, 44, 54)
        REPRO_RADIX_CASE(2400, 48, 50)
        REPRO_RADIX_CASE(2420, 44, 55)
        REPRO_RADIX_CASE(2430, 45, 54)
        REPRO_RADIX_CASE(2450, 49, 50)
        REPRO_RADIX_CASE(2464, 44, 56)
        REPRO_RADIX_CASE(2500, 50, 50)
        REPRO_RADIX_CASE(2520, 45, 56)
        REPRO_RADIX_CASE(2548, 49, 52)
        REPRO_RADIX_CASE(2592, 48, 54)
        REPRO_RADIX_CASE(2600, 50, 52)
        REPRO_RADIX_CASE(2640, 48, 55)
        REPRO_RADIX_CASE(2646, 49, 54)
        REPRO_RADIX_CASE(2700, 50, 54)
        REPRO_RADIX_CASE(2704, 52, 52)
        REPRO_RADIX_CASE(2744, 49, 56)
        REPRO_RADIX_CASE(2750, 50, 55)
        REPRO_RADIX_CASE(2772, 44, 63)
        REPRO_RADIX_CASE(2800, 50, 56)
        REPRO_RADIX_CASE(2808, 52, 54)
        REPRO_RADIX_CASE(2860, 52, 55)
        REPRO_RADIX_CASE(2912, 52, 56)
        REPRO_RADIX_CASE(2916, 54, 54)
        REPRO_RADIX_CASE(2940, 49, 60)
        REPRO_RADIX_CASE(2970, 54, 55)
        REPRO_RADIX_CASE(3000, 50, 60)
        REPRO_RADIX_CASE(3024, 54, 56)
        REPRO_RADIX_CASE(3080, 55, 56)
        REPRO_RADIX_CASE(3120, 52, 60)
        REPRO_RADIX_CASE(3150, 50, 63)
        REPRO_RADIX_CASE(3240, 54, 60)
        REPRO_RADIX_CASE(3276, 52, 63)
        REPRO_RADIX_CASE(3300, 55, 60)
        REPRO_RADIX_CASE(3360, 56, 60)
        REPRO_RADIX_CASE(3402, 54, 63)
        REPRO_RADIX_CASE(3528, 56, 63)
        REPRO_RADIX_CASE(3600, 60, 60)
        REPRO_RADIX_CASE(3780, 60, 63)
        // 17*2^k and 19*2^k past codelets of 32
        REPRO_RADIX_CASE(1088, 32, 34)
        REPRO_RADIX_CASE(2176, 34, 64)
        REPRO_RADIX_CASE(1216, 32, 38)
        REPRO_RADIX_CASE(2432, 38, 64)
        // 23*2^k past codelets of 32
        REPRO_RADIX_CASE(1472, 32, 46)
        REPRO_RADIX_CASE(2944, 46, 64)
        default:
          break;
      }
    } else {
      // complex128 only: ptxas spills the complex64 kernels of N = 208 =
      // 13x16 (4 bytes and an 8-byte stack frame at 64 registers) and N =
      // 504 = 21x24 (4 bytes and an 8-byte stack frame at 80).
      switch (n) {
        REPRO_RADIX_CASE(208, 13, 16)
        REPRO_RADIX_CASE(504, 21, 24)
        default:
          break;
      }
    }
  } else if constexpr (MODE == kRadixSplitA) {
    // Pass A: the P of kernels/split.py::FACTORS.
    switch (n) {
      REPRO_RADIX_CASE(256, 16, 16)
      REPRO_RADIX_CASE(512, 16, 32)
      default:
        break;
    }
    if constexpr (c64) {
      switch (n) {
        REPRO_RADIX_CASE(1024, 32, 32)
        default:
          break;
      }
    } else {
      switch (n) {
        REPRO_RADIX_CASE(64, 8, 8)
        REPRO_RADIX_CASE(128, 8, 16)
        default:
          break;
      }
    }
  } else {
    // Pass B: the Q of kernels/split.py::FACTORS on the radix route.
    switch (n) {
      REPRO_RADIX_CASE(256, 16, 16)
      REPRO_RADIX_CASE(512, 16, 32)
      REPRO_RADIX_CASE(1024, 32, 32)
      // the mixed lengths' rows
      REPRO_RADIX_CASE(144, 12, 12)
      REPRO_RADIX_CASE(160, 10, 16)
      REPRO_RADIX_CASE(192, 12, 16)
      REPRO_RADIX_CASE(240, 15, 16)
      REPRO_RADIX_CASE(480, 20, 24)
      REPRO_RADIX_CASE(576, 24, 24)
      REPRO_RADIX_CASE(640, 20, 32)
      REPRO_RADIX_CASE(960, 30, 32)
      REPRO_RADIX_CASE(176, 11, 16)
      REPRO_RADIX_CASE(224, 14, 16)
      REPRO_RADIX_CASE(448, 16, 28)
      REPRO_RADIX_CASE(704, 22, 32)
      REPRO_RADIX_CASE(896, 28, 32)
      REPRO_RADIX_CASE(416, 16, 26)
      REPRO_RADIX_CASE(832, 26, 32)
      // complex64 too: its pass B of 13x16 is clean (80 registers) where
      // its plain kernel spills
      REPRO_RADIX_CASE(208, 13, 16)
      // 21*2^k, 25*2^k and 27*2^k
      REPRO_RADIX_CASE(168, 12, 14)
      REPRO_RADIX_CASE(336, 16, 21)
      REPRO_RADIX_CASE(672, 24, 28)
      REPRO_RADIX_CASE(200, 10, 20)
      REPRO_RADIX_CASE(400, 20, 20)
      REPRO_RADIX_CASE(800, 25, 32)
      REPRO_RADIX_CASE(216, 12, 18)
      REPRO_RADIX_CASE(432, 18, 24)
      REPRO_RADIX_CASE(864, 27, 32)
      // 17*2^k and 19*2^k
      REPRO_RADIX_CASE(136, 8, 17)
      REPRO_RADIX_CASE(272, 16, 17)
      REPRO_RADIX_CASE(544, 17, 32)
      REPRO_RADIX_CASE(152, 8, 19)
      REPRO_RADIX_CASE(304, 16, 19)
      REPRO_RADIX_CASE(608, 19, 32)
      // the rule's rows (kernels/split.py::rule_factors) and 23*2^k's
      REPRO_RADIX_CASE(184, 8, 23)
      REPRO_RADIX_CASE(234, 13, 18)
      REPRO_RADIX_CASE(242, 11, 22)
      REPRO_RADIX_CASE(250, 10, 25)
      REPRO_RADIX_CASE(252, 14, 18)
      REPRO_RADIX_CASE(260, 13, 20)
      REPRO_RADIX_CASE(264, 12, 22)
      REPRO_RADIX_CASE(270, 15, 18)
      REPRO_RADIX_CASE(280, 14, 20)
      REPRO_RADIX_CASE(286, 13, 22)
      REPRO_RADIX_CASE(294, 14, 21)
      REPRO_RADIX_CASE(300, 15, 20)
      REPRO_RADIX_CASE(308, 14, 22)
      REPRO_RADIX_CASE(312, 13, 24)
      REPRO_RADIX_CASE(324, 18, 18)
      REPRO_RADIX_CASE(330, 15, 22)
      REPRO_RADIX_CASE(338, 13, 26)
      REPRO_RADIX_CASE(350, 14, 25)
      REPRO_RADIX_CASE(360, 18, 20)
      REPRO_RADIX_CASE(364, 14, 26)
      REPRO_RADIX_CASE(368, 16, 23)
      REPRO_RADIX_CASE(378, 18, 21)
      REPRO_RADIX_CASE(390, 15, 26)
      REPRO_RADIX_CASE(392, 14, 28)
      REPRO_RADIX_CASE(396, 18, 22)
      REPRO_RADIX_CASE(420, 20, 21)
      REPRO_RADIX_CASE(440, 20, 22)
      REPRO_RADIX_CASE(450, 18, 25)
      REPRO_RADIX_CASE(462, 21, 22)
      REPRO_RADIX_CASE(468, 18, 26)
      REPRO_RADIX_CASE(484, 22, 22)
      REPRO_RADIX_CASE(486, 18, 27)
      REPRO_RADIX_CASE(500, 20, 25)
      REPRO_RADIX_CASE(520, 20, 26)
      REPRO_RADIX_CASE(528, 22, 24)
      REPRO_RADIX_CASE(540, 20, 27)
      REPRO_RADIX_CASE(546, 21, 26)
      REPRO_RADIX_CASE(550, 22, 25)
      REPRO_RADIX_CASE(560, 20, 28)
      REPRO_RADIX_CASE(572, 22, 26)
      REPRO_RADIX_CASE(588, 21, 28)
      REPRO_RADIX_CASE(594, 22, 27)
      REPRO_RADIX_CASE(600, 24, 25)
      REPRO_RADIX_CASE(616, 22, 28)
      REPRO_RADIX_CASE(624, 24, 26)
      REPRO_RADIX_CASE(630, 21, 30)
      REPRO_RADIX_CASE(648, 24, 27)
      REPRO_RADIX_CASE(650, 25, 26)
      REPRO_RADIX_CASE(660, 22, 30)
      REPRO_RADIX_CASE(676, 26, 26)
      REPRO_RADIX_CASE(700, 25, 28)
      REPRO_RADIX_CASE(702, 26, 27)
      REPRO_RADIX_CASE(720, 24, 30)
      REPRO_RADIX_CASE(728, 26, 28)
      REPRO_RADIX_CASE(736, 23, 32)
      REPRO_RADIX_CASE(750, 25, 30)
      REPRO_RADIX_CASE(756, 27, 28)
      REPRO_RADIX_CASE(780, 26, 30)
      REPRO_RADIX_CASE(784, 28, 28)
      REPRO_RADIX_CASE(810, 27, 30)
      REPRO_RADIX_CASE(840, 28, 30)
      REPRO_RADIX_CASE(900, 30, 30)
      default:
        break;
    }
    if constexpr (c64) {
      switch (n) {
        REPRO_RADIX_CASE(128, 8, 16)
        REPRO_RADIX_CASE(2048, 32, 64)
        REPRO_RADIX_CASE(72, 8, 9)
        REPRO_RADIX_CASE(80, 8, 10)
        REPRO_RADIX_CASE(96, 8, 12)
        REPRO_RADIX_CASE(120, 10, 12)
        REPRO_RADIX_CASE(384, 16, 24)
        REPRO_RADIX_CASE(1152, 32, 36)
        REPRO_RADIX_CASE(1280, 32, 40)
        REPRO_RADIX_CASE(1536, 32, 48)
        REPRO_RADIX_CASE(1920, 40, 48)
        // 44, not 88: ptxas spills pass B of 8x11 (8 bytes at 48
        // registers)
        REPRO_RADIX_CASE(44, 4, 11)
        REPRO_RADIX_CASE(112, 8, 14)
        REPRO_RADIX_CASE(1408, 32, 44)
        REPRO_RADIX_CASE(1792, 32, 56)
        REPRO_RADIX_CASE(104, 8, 13)
        REPRO_RADIX_CASE(1664, 32, 52)
        REPRO_RADIX_CASE(84, 7, 12)
        REPRO_RADIX_CASE(1344, 32, 42)
        REPRO_RADIX_CASE(100, 10, 10)
        REPRO_RADIX_CASE(1600, 40, 40)
        REPRO_RADIX_CASE(108, 9, 12)
        REPRO_RADIX_CASE(1728, 36, 48)
        REPRO_RADIX_CASE(68, 4, 17)
        REPRO_RADIX_CASE(1088, 32, 34)
        REPRO_RADIX_CASE(76, 4, 19)
        REPRO_RADIX_CASE(1216, 32, 38)
        // the rule's rows past complex128's
        REPRO_RADIX_CASE(92, 4, 23)
        REPRO_RADIX_CASE(126, 9, 14)
        REPRO_RADIX_CASE(130, 10, 13)
        REPRO_RADIX_CASE(132, 11, 12)
        REPRO_RADIX_CASE(140, 10, 14)
        REPRO_RADIX_CASE(150, 10, 15)
        REPRO_RADIX_CASE(154, 11, 14)
        REPRO_RADIX_CASE(156, 12, 13)
        REPRO_RADIX_CASE(162, 9, 18)
        REPRO_RADIX_CASE(180, 12, 15)
        REPRO_RADIX_CASE(182, 13, 14)
        REPRO_RADIX_CASE(196, 14, 14)
        REPRO_RADIX_CASE(198, 11, 18)
        REPRO_RADIX_CASE(210, 14, 15)
        REPRO_RADIX_CASE(220, 11, 20)
        REPRO_RADIX_CASE(490, 14, 35)
        REPRO_RADIX_CASE(686, 14, 49)
        REPRO_RADIX_CASE(726, 22, 33)
        REPRO_RADIX_CASE(770, 22, 35)
        REPRO_RADIX_CASE(792, 24, 33)
        REPRO_RADIX_CASE(858, 26, 33)
        REPRO_RADIX_CASE(880, 22, 40)
        REPRO_RADIX_CASE(882, 21, 42)
        REPRO_RADIX_CASE(910, 26, 35)
        REPRO_RADIX_CASE(924, 28, 33)
        REPRO_RADIX_CASE(936, 26, 36)
        REPRO_RADIX_CASE(968, 22, 44)
        REPRO_RADIX_CASE(972, 27, 36)
        REPRO_RADIX_CASE(980, 28, 35)
        REPRO_RADIX_CASE(990, 30, 33)
        REPRO_RADIX_CASE(1000, 25, 40)
        REPRO_RADIX_CASE(1008, 28, 36)
        REPRO_RADIX_CASE(1014, 26, 39)
        REPRO_RADIX_CASE(1040, 26, 40)
        REPRO_RADIX_CASE(1050, 30, 35)
        REPRO_RADIX_CASE(1056, 32, 33)
        REPRO_RADIX_CASE(1078, 22, 49)
        REPRO_RADIX_CASE(1080, 30, 36)
        REPRO_RADIX_CASE(1092, 28, 39)
        REPRO_RADIX_CASE(1100, 25, 44)
        REPRO_RADIX_CASE(1120, 32, 35)
        REPRO_RADIX_CASE(1134, 27, 42)
        REPRO_RADIX_CASE(1144, 26, 44)
        REPRO_RADIX_CASE(1170, 30, 39)
        REPRO_RADIX_CASE(1176, 28, 42)
        REPRO_RADIX_CASE(1188, 33, 36)
        REPRO_RADIX_CASE(1200, 30, 40)
        REPRO_RADIX_CASE(1210, 22, 55)
        REPRO_RADIX_CASE(1232, 28, 44)
        REPRO_RADIX_CASE(1248, 32, 39)
        REPRO_RADIX_CASE(1250, 25, 50)
        REPRO_RADIX_CASE(1260, 35, 36)
        REPRO_RADIX_CASE(1274, 26, 49)
        REPRO_RADIX_CASE(1296, 36, 36)
        REPRO_RADIX_CASE(1300, 26, 50)
        REPRO_RADIX_CASE(1320, 33, 40)
        REPRO_RADIX_CASE(1350, 30, 45)
        REPRO_RADIX_CASE(1352, 26, 52)
        REPRO_RADIX_CASE(1372, 28, 49)
        REPRO_RADIX_CASE(1386, 33, 42)
        REPRO_RADIX_CASE(1400, 35, 40)
        REPRO_RADIX_CASE(1404, 36, 39)
        REPRO_RADIX_CASE(1430, 26, 55)
        REPRO_RADIX_CASE(1440, 36, 40)
        REPRO_RADIX_CASE(1452, 33, 44)
        REPRO_RADIX_CASE(1456, 28, 52)
        REPRO_RADIX_CASE(1458, 27, 54)
        REPRO_RADIX_CASE(1470, 35, 42)
        REPRO_RADIX_CASE(1472, 32, 46)
        REPRO_RADIX_CASE(1500, 30, 50)
        REPRO_RADIX_CASE(1512, 36, 42)
        REPRO_RADIX_CASE(1540, 35, 44)
        REPRO_RADIX_CASE(1560, 39, 40)
        REPRO_RADIX_CASE(1568, 32, 49)
        REPRO_RADIX_CASE(1584, 36, 44)
        REPRO_RADIX_CASE(1620, 36, 45)
        REPRO_RADIX_CASE(1638, 39, 42)
        REPRO_RADIX_CASE(1650, 33, 50)
        REPRO_RADIX_CASE(1680, 40, 42)
        REPRO_RADIX_CASE(1716, 39, 44)
        REPRO_RADIX_CASE(1750, 35, 50)
        REPRO_RADIX_CASE(1760, 40, 44)
        REPRO_RADIX_CASE(1764, 42, 42)
        REPRO_RADIX_CASE(1782, 33, 54)
        REPRO_RADIX_CASE(1800, 40, 45)
        REPRO_RADIX_CASE(1820, 35, 52)
        REPRO_RADIX_CASE(1848, 42, 44)
        REPRO_RADIX_CASE(1872, 39, 48)
        REPRO_RADIX_CASE(1890, 42, 45)
        default:
          break;
      }
    } else {
      switch (n) {
        REPRO_RADIX_CASE(768, 24, 32)
        // the rule's rows: complex128 only, as complex64 504 = 21x24
        // spills (radix._SPILLS)
        REPRO_RADIX_CASE(504, 21, 24)
        default:
          break;
      }
    }
  }
#undef REPRO_RADIX_CASE
  return (int)cudaErrorInvalidValue;
}
#endif

// Lines of n on the radix kernel of MODE: radix_part of n's build part.
template <typename R, int MODE, int P = 0>
int radix_dispatch(int n, const void* x, void* out, const void* consts,
                   const void* tw, long long outer, long long inner,
                   int inverse, int seg_arg, int lines_log2, int strided,
                   int aux_log2, int smem_bytes, cudaStream_t stream) {
  if constexpr (P + 1 < kBuildParts) {
    if (build_part(n, MODE, sizeof(R) == sizeof(float)) != P)
      return radix_dispatch<R, MODE, P + 1>(
          n, x, out, consts, tw, outer, inner, inverse, seg_arg, lines_log2,
          strided, aux_log2, smem_bytes, stream);
  }
  return radix_part<R, MODE, P>(n, x, out, consts, tw, outer, inner,
                                inverse, seg_arg, lines_log2, strided,
                                aux_log2, smem_bytes, stream);
}

}  // namespace repro_fft
