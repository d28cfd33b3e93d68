// The wide lines of B1 on Hopper: the lengths of the radix route whose
// larger factor passes a codelet the long-line route keeps in registers
// (complex64 past 32 values, complex128 past 16), such as complex64 2944 =
// 46 x 64, 3600 = 60 x 60 and 4096 = 64 x 64 or complex128 864 = 27 x 32,
// that three codelets of at most 32 values hold (kernels/longline.py::
// WIDE, wide_candidates), on contiguous (B, N) lines.
//
// Replaces, for these N, the radix route's kernel (fft_radix.cuh,
// radix_kernel), which ran them as two passes of in-register codelets of
// N1 and N2 values (the TPU kernel's two contractions,
// src/repro/kernels/fft_matmul.py::_fft_kernel, and its twiddle and
// pack_parts epilogues).  What held that kernel back on an H100:
//  * a thread held a codelet of up to 64 complex64 values, 191-255
//    registers, so one block of 256 threads filled an SM's 65536 and the
//    SM ran 8 warps;
//  * its tile held two lines at these lengths, so half the block idled in
//    a pass of N/64 items;
//  * its loads went to registers and no copy was in flight while a tile
//    was transformed, so an SM moved no HBM bytes meanwhile.
// HBM bytes bound these lengths (about 5*log2(N) flops an element against
// 16 bytes of complex64 moved), so the design keeps the SM's memory
// traffic going:
//  * Three passes over N = R1*R2*R3, each an in-register codelet of at most
//    32 values (R3 at most 16, a power of two; R1 and R2 a radix-2 codelet
//    or the radix route's mixed chain, each on its own table): complex64
//    fits in 128 registers a thread, so four blocks of 128 threads share
//    an SM, 16 warps (complex128: two, at up to 255 registers); blocks of
//    256 threads ran 0-40% slower (PERF.md §6, the wide kernel's sweep).
//  * A tile of LT consecutive lines, so that each pass's LT*N/R_i items
//    fill the block's rounds (kernels/longline.py::wide_candidates picks
//    the split and LT); each pass walks its items in rounds of the block,
//    item by item in place: long_mixed_kernel's body (fft_long.cuh::
//    mixed_tiles), which that kernel runs on one line a tile.
//  * The tile arrives by bulk asynchronous copies (TMA): its LT*R1 rows of
//    N/R1 values at a row pitch padded by 16 bytes (pass 3's reads of
//    consecutive kA fall R1 rows apart, on distinct banks), issued by the
//    lanes of warp 0 on one mbarrier per ring slot.  A ring of two tiles
//    and a persistent grid: once pass 3 has read a slot, the copy of the
//    block's tile after next starts into it, so the next tile's copy is in
//    flight while this one is transformed.
//  * The last tile of the grid may hold fewer than LT lines: its copy and
//    its passes cover only those (the mbarrier expects their bytes).
//  * Pass 3's items are consecutive output indices kA = k1 + R1*k2 of a
//    line, so its stores (with the output twiddle, 1/N and the pack_parts
//    segment, seg any length) cover whole sectors of HBM.
// kernels/longline.py holds the same plan and index maps in Python
// (longline.emulate, with the plan's LT, is this kernel's plain version).
#pragma once

#include <cstdint>

#include "fft_long.cuh"

namespace repro_fft {

// Threads of a wide block: four blocks an SM for complex64 at 128
// registers a thread, two for complex128 (kernels/longline.py::
// WIDE_THREADS; blocks of 256 read 0-40% slower, PERF.md §6).
constexpr int kWideThreads = 128;

// Shared memory of one block: the ring's two tiles of LT lines, the
// constants, one mbarrier per tile (kernels/longline.py::WidePlan.
// smem_bytes).
template <typename R, int R1, int R2, int R3, int LT>
__host__ __device__ constexpr size_t wide_smem_bytes() {
  static_assert(R1 <= 32 && R2 <= 32 && R3 <= 16,
                "codelets of at most 32 values");
  return long_mixed_smem_bytes<R, R1, R2, R3, 2, LT>();
}

// The wide lines' kernel: long_mixed_kernel's body (mixed_tiles, fft_long.
// cuh) on tiles of LT lines in a ring of two, whose rows warp 0 copies,
// kWideThreads threads and at least MINB blocks an SM (the launch bound:
// 128 registers a thread for complex64).
template <typename R, int R1, int R2, int R3, int LT, int MINB>
__global__ void __launch_bounds__(kWideThreads, MINB)
wide_kernel(const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
            const cpx<R>* __restrict__ consts,
            const cpx<R>* __restrict__ gtw, long long batch, int inverse,
            int seg) {
  mixed_tiles<R, R1, R2, R3, LT, kWideThreads, 2, 32>(x, out, consts, gtw,
                                                      batch, inverse, seg);
}
// Launches wide_kernel on a persistent grid: as many blocks as fit on the
// SMs, at most one per tile.  `smem_bytes` must equal the plan's layout
// (kernels/longline.py::WidePlan.smem_bytes).
template <typename R, int R1, int R2, int R3, int LT, int MINB>
int wide_launch(const void* x, void* out, const void* consts, const void* tw,
                long long batch, int inverse, int seg, int smem_bytes,
                cudaStream_t stream) {
  constexpr auto kernel = wide_kernel<R, R1, R2, R3, LT, MINB>;
  if ((size_t)smem_bytes != wide_smem_bytes<R, R1, R2, R3, LT>())
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  if (seg < 1 || (R1 * R2 * R3) % seg) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kWideThreads, (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (batch + LT - 1) / LT;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > tiles) grid = tiles;
  kernel<<<(unsigned)grid, kWideThreads, (size_t)smem_bytes, stream>>>(
      static_cast<const cpx<R>*>(x), static_cast<cpx<R>*>(out),
      static_cast<const cpx<R>*>(consts), static_cast<const cpx<R>*>(tw),
      batch, inverse, seg);
  return (int)cudaGetLastError();
}

// The wide lengths' kernels, in build_part.
constexpr int kWideMode = 5;

// The lengths of build part PART on the wide kernel; cudaErrorInvalidValue
// for any other N.
template <typename R, int PART>
int wide_part(int n, const void* x, void* out, const void* consts,
              const void* tw, long long batch, int inverse, int seg,
              int smem_bytes, cudaStream_t stream);

#if !defined(REPRO_PART) || REPRO_PART >= 0
template <typename R, int PART>
int wide_part(int n, const void* x, void* out, const void* consts,
              const void* tw, long long batch, int inverse, int seg,
              int smem_bytes, cudaStream_t stream) {
  constexpr bool c64 = sizeof(R) == sizeof(float);
#define REPRO_WIDE_CASE(NN, A, B, C, LT, MINB)                             \
  case NN:                                                                 \
    if constexpr (build_part(NN, kWideMode, c64) == PART)                  \
      return wide_launch<R, A, B, C, LT, MINB>(                            \
          x, out, consts, tw, batch, inverse, seg, smem_bytes, stream);    \
    break;
  // kernels/longline.py::WIDE lists the same plans: (R1, R2, R3), LT and
  // (WidePlan.min_blocks) blocks an SM.
  if constexpr (c64) {
    switch (n) {
      // BEGIN c64 cases
      REPRO_WIDE_CASE(792, 11, 9, 8, 4, 4)
      REPRO_WIDE_CASE(880, 22, 5, 8, 3, 4)
      REPRO_WIDE_CASE(882, 21, 21, 2, 3, 4)
      REPRO_WIDE_CASE(924, 22, 21, 2, 3, 4)
      REPRO_WIDE_CASE(936, 13, 9, 8, 3, 4)
      REPRO_WIDE_CASE(968, 11, 11, 8, 1, 4)
      REPRO_WIDE_CASE(1000, 25, 5, 8, 3, 4)
      REPRO_WIDE_CASE(1008, 14, 9, 8, 3, 4)
      REPRO_WIDE_CASE(1040, 13, 5, 16, 3, 4)
      REPRO_WIDE_CASE(1050, 25, 21, 2, 2, 4)
      REPRO_WIDE_CASE(1092, 21, 13, 4, 2, 4)
      REPRO_WIDE_CASE(1100, 25, 22, 2, 2, 4)
      REPRO_WIDE_CASE(1120, 20, 7, 8, 2, 4)
      REPRO_WIDE_CASE(1134, 27, 21, 2, 2, 4)
      REPRO_WIDE_CASE(1144, 22, 13, 4, 2, 4)
      REPRO_WIDE_CASE(1152, 24, 24, 2, 2, 4)
      REPRO_WIDE_CASE(1176, 21, 7, 8, 2, 4)
      REPRO_WIDE_CASE(1188, 27, 11, 4, 2, 4)
      REPRO_WIDE_CASE(1200, 25, 12, 4, 2, 4)
      REPRO_WIDE_CASE(1216, 19, 8, 8, 2, 4)
      REPRO_WIDE_CASE(1232, 22, 7, 8, 2, 4)
      REPRO_WIDE_CASE(1248, 24, 13, 4, 2, 4)
      REPRO_WIDE_CASE(1250, 25, 25, 2, 2, 4)
      REPRO_WIDE_CASE(1260, 21, 15, 4, 2, 4)
      REPRO_WIDE_CASE(1280, 20, 8, 8, 2, 4)
      REPRO_WIDE_CASE(1296, 27, 24, 2, 2, 4)
      REPRO_WIDE_CASE(1300, 25, 13, 4, 2, 4)
      REPRO_WIDE_CASE(1320, 15, 11, 8, 2, 4)
      REPRO_WIDE_CASE(1344, 21, 8, 8, 2, 4)
      REPRO_WIDE_CASE(1350, 27, 25, 2, 2, 4)
      REPRO_WIDE_CASE(1352, 13, 13, 8, 2, 4)
      REPRO_WIDE_CASE(1400, 25, 14, 4, 2, 4)
      REPRO_WIDE_CASE(1404, 27, 26, 2, 2, 4)
      REPRO_WIDE_CASE(1408, 22, 8, 8, 2, 4)
      REPRO_WIDE_CASE(1440, 15, 12, 8, 2, 4)
      REPRO_WIDE_CASE(1456, 14, 13, 8, 2, 4)
      REPRO_WIDE_CASE(1458, 27, 27, 2, 2, 4)
      REPRO_WIDE_CASE(1472, 23, 8, 8, 2, 4)
      REPRO_WIDE_CASE(1500, 25, 15, 4, 2, 4)
      REPRO_WIDE_CASE(1512, 27, 14, 4, 2, 4)
      REPRO_WIDE_CASE(1536, 24, 8, 8, 2, 4)
      REPRO_WIDE_CASE(1560, 15, 13, 8, 1, 4)
      REPRO_WIDE_CASE(1568, 14, 7, 16, 1, 4)
      REPRO_WIDE_CASE(1584, 11, 9, 16, 2, 4)
      REPRO_WIDE_CASE(1600, 25, 8, 8, 2, 4)
      REPRO_WIDE_CASE(1620, 27, 15, 4, 1, 4)
      REPRO_WIDE_CASE(1664, 13, 8, 16, 1, 4)
      REPRO_WIDE_CASE(1680, 15, 7, 16, 1, 4)
      REPRO_WIDE_CASE(1728, 18, 6, 16, 1, 4)
      REPRO_WIDE_CASE(1760, 22, 5, 16, 1, 4)
      REPRO_WIDE_CASE(1764, 21, 21, 4, 1, 4)
      REPRO_WIDE_CASE(1792, 16, 7, 16, 1, 4)
      REPRO_WIDE_CASE(1800, 15, 15, 8, 1, 4)
      REPRO_WIDE_CASE(1848, 22, 21, 4, 1, 4)
      REPRO_WIDE_CASE(1872, 13, 9, 16, 1, 4)
      REPRO_WIDE_CASE(1920, 15, 8, 16, 1, 4)
      REPRO_WIDE_CASE(1936, 22, 22, 4, 1, 4)
      REPRO_WIDE_CASE(1944, 27, 9, 8, 1, 4)
      REPRO_WIDE_CASE(2000, 25, 20, 4, 1, 4)
      REPRO_WIDE_CASE(2016, 21, 6, 16, 1, 4)
      REPRO_WIDE_CASE(2048, 16, 8, 16, 1, 4)
      REPRO_WIDE_CASE(2080, 20, 13, 8, 1, 4)
      REPRO_WIDE_CASE(2100, 25, 21, 4, 1, 4)
      REPRO_WIDE_CASE(2112, 24, 22, 4, 1, 4)
      REPRO_WIDE_CASE(2160, 27, 20, 4, 1, 4)
      REPRO_WIDE_CASE(2176, 32, 17, 4, 1, 4)
      REPRO_WIDE_CASE(2184, 21, 13, 8, 1, 4)
      REPRO_WIDE_CASE(2200, 25, 22, 4, 1, 4)
      REPRO_WIDE_CASE(2240, 20, 14, 8, 1, 4)
      REPRO_WIDE_CASE(2268, 27, 21, 4, 1, 4)
      REPRO_WIDE_CASE(2288, 22, 13, 8, 1, 4)
      REPRO_WIDE_CASE(2304, 24, 24, 4, 1, 4)
      REPRO_WIDE_CASE(2352, 21, 14, 8, 1, 4)
      REPRO_WIDE_CASE(2376, 27, 22, 4, 1, 4)
      REPRO_WIDE_CASE(2400, 25, 24, 4, 1, 4)
      REPRO_WIDE_CASE(2432, 32, 19, 4, 1, 4)
      REPRO_WIDE_CASE(2464, 22, 14, 8, 1, 4)
      REPRO_WIDE_CASE(2496, 24, 13, 8, 1, 4)
      REPRO_WIDE_CASE(2500, 25, 25, 4, 1, 4)
      REPRO_WIDE_CASE(2520, 21, 15, 8, 1, 4)
      REPRO_WIDE_CASE(2560, 32, 20, 4, 1, 4)
      REPRO_WIDE_CASE(2592, 27, 12, 8, 1, 4)
      REPRO_WIDE_CASE(2600, 25, 13, 8, 1, 4)
      REPRO_WIDE_CASE(2640, 22, 15, 8, 1, 4)
      REPRO_WIDE_CASE(2688, 24, 14, 8, 1, 4)
      REPRO_WIDE_CASE(2700, 27, 25, 4, 1, 4)
      REPRO_WIDE_CASE(2704, 13, 13, 16, 1, 4)
      REPRO_WIDE_CASE(2800, 25, 14, 8, 1, 4)
      REPRO_WIDE_CASE(2808, 27, 13, 8, 1, 4)
      REPRO_WIDE_CASE(2816, 32, 11, 8, 1, 4)
      REPRO_WIDE_CASE(2880, 24, 15, 8, 1, 4)
      REPRO_WIDE_CASE(2912, 14, 13, 16, 1, 4)
      REPRO_WIDE_CASE(2916, 27, 27, 4, 1, 4)
      REPRO_WIDE_CASE(2944, 32, 23, 4, 1, 4)
      REPRO_WIDE_CASE(3000, 25, 15, 8, 1, 4)
      REPRO_WIDE_CASE(3024, 27, 14, 8, 1, 4)
      REPRO_WIDE_CASE(3072, 32, 12, 8, 1, 4)
      REPRO_WIDE_CASE(3120, 15, 13, 16, 1, 4)
      REPRO_WIDE_CASE(3136, 14, 14, 16, 1, 4)
      REPRO_WIDE_CASE(3200, 32, 25, 4, 1, 3)
      REPRO_WIDE_CASE(3240, 27, 15, 8, 1, 3)
      REPRO_WIDE_CASE(3328, 32, 26, 4, 1, 3)
      REPRO_WIDE_CASE(3360, 15, 14, 16, 1, 3)
      REPRO_WIDE_CASE(3456, 32, 27, 4, 1, 3)
      REPRO_WIDE_CASE(3520, 20, 11, 16, 1, 3)
      REPRO_WIDE_CASE(3528, 21, 21, 8, 1, 3)
      REPRO_WIDE_CASE(3584, 32, 28, 4, 1, 3)
      REPRO_WIDE_CASE(3600, 15, 15, 16, 1, 3)
      REPRO_WIDE_CASE(3840, 16, 15, 16, 1, 3)
      REPRO_WIDE_CASE(4032, 21, 12, 16, 1, 3)
      REPRO_WIDE_CASE(4096, 16, 16, 16, 1, 3)
      // END c64 cases
      default:
        break;
    }
  } else {
    switch (n) {
      // BEGIN c128 cases
      REPRO_WIDE_CASE(384, 8, 6, 8, 8, 2)
      REPRO_WIDE_CASE(390, 15, 13, 2, 8, 2)
      REPRO_WIDE_CASE(392, 14, 14, 2, 8, 2)
      REPRO_WIDE_CASE(396, 11, 9, 4, 7, 2)
      REPRO_WIDE_CASE(400, 10, 10, 4, 6, 2)
      REPRO_WIDE_CASE(416, 13, 2, 16, 8, 2)
      REPRO_WIDE_CASE(420, 15, 14, 2, 4, 2)
      REPRO_WIDE_CASE(432, 9, 6, 8, 7, 2)
      REPRO_WIDE_CASE(440, 11, 5, 8, 6, 2)
      REPRO_WIDE_CASE(448, 14, 2, 16, 4, 2)
      REPRO_WIDE_CASE(450, 15, 15, 2, 4, 2)
      REPRO_WIDE_CASE(462, 21, 11, 2, 5, 2)
      REPRO_WIDE_CASE(468, 13, 9, 4, 7, 2)
      REPRO_WIDE_CASE(480, 15, 4, 8, 4, 2)
      REPRO_WIDE_CASE(484, 11, 11, 4, 5, 2)
      REPRO_WIDE_CASE(500, 25, 5, 4, 6, 2)
      REPRO_WIDE_CASE(504, 14, 9, 4, 6, 2)
      REPRO_WIDE_CASE(520, 13, 5, 8, 6, 2)
      REPRO_WIDE_CASE(528, 11, 6, 8, 5, 2)
      REPRO_WIDE_CASE(540, 15, 9, 4, 6, 2)
      REPRO_WIDE_CASE(544, 17, 4, 8, 4, 2)
      REPRO_WIDE_CASE(546, 21, 13, 2, 6, 2)
      REPRO_WIDE_CASE(550, 25, 11, 2, 5, 2)
      REPRO_WIDE_CASE(560, 14, 10, 4, 6, 2)
      REPRO_WIDE_CASE(572, 13, 11, 4, 5, 2)
      REPRO_WIDE_CASE(588, 21, 7, 4, 4, 2)
      REPRO_WIDE_CASE(594, 27, 11, 2, 5, 2)
      REPRO_WIDE_CASE(600, 15, 5, 8, 3, 2)
      REPRO_WIDE_CASE(608, 19, 4, 8, 4, 2)
      REPRO_WIDE_CASE(616, 11, 7, 8, 4, 2)
      REPRO_WIDE_CASE(630, 21, 15, 2, 3, 2)
      REPRO_WIDE_CASE(640, 8, 5, 16, 3, 2)
      REPRO_WIDE_CASE(648, 9, 9, 8, 5, 2)
      REPRO_WIDE_CASE(650, 25, 13, 2, 4, 2)
      REPRO_WIDE_CASE(676, 13, 13, 4, 2, 2)
      REPRO_WIDE_CASE(700, 25, 14, 2, 4, 2)
      REPRO_WIDE_CASE(702, 27, 13, 2, 4, 2)
      REPRO_WIDE_CASE(704, 11, 8, 8, 4, 2)
      REPRO_WIDE_CASE(720, 20, 18, 2, 3, 2)
      REPRO_WIDE_CASE(728, 14, 13, 4, 2, 2)
      REPRO_WIDE_CASE(736, 23, 4, 8, 4, 2)
      REPRO_WIDE_CASE(750, 25, 15, 2, 4, 2)
      REPRO_WIDE_CASE(756, 21, 18, 2, 3, 2)
      REPRO_WIDE_CASE(780, 15, 13, 4, 4, 2)
      REPRO_WIDE_CASE(784, 14, 14, 4, 4, 2)
      REPRO_WIDE_CASE(800, 20, 10, 4, 3, 2)
      REPRO_WIDE_CASE(810, 27, 15, 2, 4, 2)
      REPRO_WIDE_CASE(832, 13, 4, 16, 4, 2)
      REPRO_WIDE_CASE(840, 15, 14, 4, 4, 2)
      REPRO_WIDE_CASE(864, 18, 3, 16, 2, 2)
      REPRO_WIDE_CASE(896, 8, 7, 16, 2, 2)
      REPRO_WIDE_CASE(900, 15, 15, 4, 2, 2)
      REPRO_WIDE_CASE(960, 15, 8, 8, 2, 2)
      REPRO_WIDE_CASE(1024, 8, 8, 16, 2, 2)
      // END c128 cases
      default:
        break;
    }
  }
#undef REPRO_WIDE_CASE
  return (int)cudaErrorInvalidValue;
}
#endif

// Lines of n on the wide kernel: wide_part of n's build part.
template <typename R, int P = 0>
int wide_dispatch(int n, const void* x, void* out, const void* consts,
                  const void* tw, long long batch, int inverse, int seg,
                  int smem_bytes, cudaStream_t stream) {
  if constexpr (P + 1 < kBuildParts) {
    if (build_part(n, kWideMode, sizeof(R) == sizeof(float)) != P)
      return wide_dispatch<R, P + 1>(n, x, out, consts, tw, batch, inverse,
                                     seg, smem_bytes, stream);
  }
  return wide_part<R, P>(n, x, out, consts, tw, batch, inverse, seg,
                         smem_bytes, stream);
}

}  // namespace repro_fft
