// Batched 1-D FFT of complex lines for Hopper: the port's entry points.
//
// Five routes, chosen by the wrapper from N and the dtype alone
// (kernels/radix.py::kernel_path): every even N whose only prime factors are
// 2, 3, 5, 7, 11 and 13, and every 17*2^k, 19*2^k and 23*2^k, whose two
// factors both fit a codelet of 64 values (complex64) or 32 (complex128),
// so that the codelets stay in registers -- the powers of two up to 4096
// (complex64) or 1024 (complex128) and the mixed N = r*2^k, r from 3 to
// 1701 (radix.RADIX_ODD) -- takes the radix route (fft_radix.cuh: two
// passes of in-register codelets, contiguous or strided lines), but for
// the wide lines among them (a factor past 32 values, complex64, or 16,
// complex128: longline.WIDE), whose contiguous lines take the long route's
// tile kernel (fft_wide.cuh: LT lines a block by TMA, three passes of
// codelets of at most 32 values, repro_fft_wide_* below); the longer
// powers of two and mixed N (odd part 3 to 15, 17, 19, 21, 23, 25 or 27:
// radix.EVERY_ROUTE_ODD; the other 13-smooth ones that three codelets
// hold) whose line fits in one block's shared memory take the long-line
// route (fft_long.cuh: three passes over a line loaded by TMA); beyond one
// block (complex64 to 2^24, complex128 to 2^22) the powers of two and the
// mixed N of radix.EVERY_ROUTE_ODD, and every other 13-smooth N or 23*2^k
// whose N = P*Q a radix or long-line row holds (split.rule_factors), and
// every other 13-smooth N (split.general_factors), take the split route
// (kernels/split.py: pass A a strided radix launch on the P-long columns
// with the inter-step twiddle, P a power of two, or the dense kernel's
// column form; pass B on the Q-long rows stored transposed: a radix
// launch, or the long-line or dense stages with a thread-block cluster's
// store; a nested plan's rows on another route, in natural order, and a
// transpose); every N up to
// complex64 4835 / complex128 2419 that those routes do not take and
// whose generic stages (one per prime factor past 13) cost no more than
// the chirp route (dense.GENERIC_COST: odd N, the even 13-smooth N no
// codelets hold, N with cheap primes past 13), and every other 13-smooth
// N whose line fits one block (complex64 to 28431, complex128 to 14196),
// takes the dense route (fft_dense.cuh: a mixed-radix FFT over a run-time
// chain, the line in shared memory; kernels/dense.py); past the split
// route's limits, up to 2^30, every N with a 13-smooth P on a column pass
// and rows on another route takes its nested plans (the rows' own
// launch); any other N up to 2^30 (dearer prime factors, a prime factor
// past 13 that no codelet or nested plan takes) takes the chirp route
// (kernels/chirp.py: Bluestein's convolution as two transforms of the
// cheapest 13-smooth M from 2N - 1, the first one's load reading the
// input times the chirp, the second one's store keeping the first N: the
// dense route's, the long-line route's and the split route's pass A and
// row pass (or pass C) kernels each have that form, the *_chirp_* and
// *_keep_* entry points below).
//
// Replaces the TPU kernel src/repro/kernels/fft_matmul.py::_fft_kernel (the
// pl.pallas_call in fft1d_planes), with its two fused epilogues: the
// elementwise output twiddle and the pack_parts store.  Each route's
// header says what bounds it on an H100 and what its design does about
// it.
//
// The build (kernels/build.py) compiles this file as REPRO_BUILD_PARTS + 1
// translation units at once and links them into one library: with
// REPRO_PART = k, only the radix and long-line kernels of build part k
// (repro_fft::build_part: the hash that spreads the lengths over the
// parts), explicitly instantiated below; with REPRO_PART = -1, the dense
// kernels (per dtype: the dense route's and the split route's column
// form), the split route's transposes and the C entry points, which
// route each length to its part's radix_part or long_part.
// Compiled with neither macro, it is the whole library in one unit.

#include <cuda_runtime.h>

#include "fft_common.cuh"
#include "fft_long.cuh"
#include "fft_radix.cuh"
// last: the other routes' functions keep their SASS
#include "fft_dense.cuh"
#include "fft_wide.cuh"

#if defined(REPRO_PART) && REPRO_PART >= 0

#define REPRO_RADIX_PART(R, MODE)                                          \
  template int repro_fft::radix_part<R, repro_fft::MODE, REPRO_PART>(      \
      int, const void*, void*, const void*, const void*, long long,        \
      long long, int, int, int, int, int, int, cudaStream_t);
#define REPRO_LONG_PART(R)                                                 \
  template int repro_fft::long_part<R, REPRO_PART>(                        \
      int, const void*, void*, const void*, const void*, long long, int,   \
      int, int, cudaStream_t);
REPRO_RADIX_PART(float, kRadixPlain)
REPRO_RADIX_PART(double, kRadixPlain)
REPRO_RADIX_PART(float, kRadixSplitA)
REPRO_RADIX_PART(double, kRadixSplitA)
REPRO_RADIX_PART(float, kRadixSplitB)
REPRO_RADIX_PART(double, kRadixSplitB)
REPRO_LONG_PART(float)
REPRO_LONG_PART(double)
#define REPRO_LONG_CHIRP_PART(R)                                           \
  template int repro_fft::long_chirp_part<R, REPRO_PART>(                  \
      int, int, const void*, void*, const void*, const void*, const void*, \
      long long, int, int, int, int, int, int, cudaStream_t);
REPRO_LONG_CHIRP_PART(float)
REPRO_LONG_CHIRP_PART(double)
#define REPRO_WIDE_PART(R)                                                 \
  template int repro_fft::wide_part<R, REPRO_PART>(                        \
      int, const void*, void*, const void*, const void*, long long, int,   \
      int, int, cudaStream_t);
REPRO_WIDE_PART(float)
REPRO_WIDE_PART(double)
#define REPRO_SPLIT_FOLD_PART(R)                                           \
  template int repro_fft::split_fold_part<R, REPRO_PART>(                  \
      int, const void*, void*, const void*, const void*, long long, int,   \
      int, int, int, int, cudaStream_t);
REPRO_SPLIT_FOLD_PART(float)
REPRO_SPLIT_FOLD_PART(double)
#undef REPRO_RADIX_PART
#undef REPRO_LONG_PART
#undef REPRO_LONG_CHIRP_PART
#undef REPRO_WIDE_PART
#undef REPRO_SPLIT_FOLD_PART

#else

extern "C" {

// The dense route (fft_dense.cuh) for the N of kernels/dense.py::takes.
// `consts` and `ints` are dense.constants' tables; `tw` may be null; `x`
// is contiguous (B, N) lines, `out` (parts, B, N/parts) with seg =
// N/parts.  The layout's numbers and the block's threads are
// dense.DensePlan's.  Returns the CUDA error code of the launch (0 on
// success).
int repro_fft_dense_c64(const void* x, void* out, const void* consts,
                        const void* ints, const void* tw, long long batch,
                        int n, int stages, int lines, int t_log2, int lo,
                        int n_consts, int n_ints, int buf_off, int inverse,
                        int seg, int threads, int smem_bytes, void* stream) {
  return repro_fft::dense_launch<float>(
      x, out, consts, ints, tw, batch, n, stages, lines, t_log2, lo,
      n_consts, n_ints, buf_off, inverse, seg, threads, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

int repro_fft_dense_c128(const void* x, void* out, const void* consts,
                         const void* ints, const void* tw, long long batch,
                         int n, int stages, int lines, int t_log2, int lo,
                         int n_consts, int n_ints, int buf_off, int inverse,
                         int seg, int threads, int smem_bytes,
                         void* stream) {
  return repro_fft::dense_launch<double>(
      x, out, consts, ints, tw, batch, n, stages, lines, t_log2, lo,
      n_consts, n_ints, buf_off, inverse, seg, threads, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

// The radix path (fft_radix.cuh) for the N of radix.RADIX_SIZES.
// `consts` holds T (N1 x N2) then the codelet tables (radix.codelet_table);
// `tw` may be null.  Contiguous lines: outer = B, inner = 1, strided = 0,
// `out` (parts, B, N/parts) with seg_arg = log2(N/parts) for a power-of-two
// N, N/parts for a mixed N.  Strided lines: `x` and `out` are contiguous
// (outer, N, inner), strided = 1, seg_arg = log2(N) or N.  Returns the
// CUDA error code of the launch (0 on success).
int repro_fft_radix_c64(const void* x, void* out, const void* consts,
                        const void* tw, long long outer, long long inner,
                        int n, int inverse, int seg_arg, int lines_log2,
                        int strided, int smem_bytes, void* stream) {
  return repro_fft::radix_dispatch<float, repro_fft::kRadixPlain>(
      n, x, out, consts, tw, outer, inner, inverse, seg_arg, lines_log2,
      strided, 0, smem_bytes, static_cast<cudaStream_t>(stream));
}

int repro_fft_radix_c128(const void* x, void* out, const void* consts,
                         const void* tw, long long outer, long long inner,
                         int n, int inverse, int seg_arg, int lines_log2,
                         int strided, int smem_bytes, void* stream) {
  return repro_fft::radix_dispatch<double, repro_fft::kRadixPlain>(
      n, x, out, consts, tw, outer, inner, inverse, seg_arg, lines_log2,
      strided, 0, smem_bytes, static_cast<cudaStream_t>(stream));
}

// The long-line route (fft_long.cuh) for the N that
// kernels/longline.py::FACTORS lists.  `consts` holds TA, TB, TC and the
// codelet tables (longline.constants); `tw` may be null; `x` is contiguous
// (B, N) lines, 16-byte aligned, and `out` (parts, B, N/parts) with
// seg_arg = log2(N/parts) for a power-of-two N, N/parts for a mixed N.
// `smem_bytes` must equal the layout's size
// (longline.smem_bytes at longline.long_tile's ring depth).
// Returns the CUDA error code of the launch (0 on success).
int repro_fft_long_c64(const void* x, void* out, const void* consts,
                       const void* tw, long long batch, int n, int inverse,
                       int seg_arg, int smem_bytes, void* stream) {
  return repro_fft::long_dispatch<float>(
      n, x, out, consts, tw, batch, inverse, seg_arg, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

int repro_fft_long_c128(const void* x, void* out, const void* consts,
                        const void* tw, long long batch, int n, int inverse,
                        int seg_arg, int smem_bytes, void* stream) {
  return repro_fft::long_dispatch<double>(
      n, x, out, consts, tw, batch, inverse, seg_arg, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

// The long route's wide lines (fft_wide.cuh) for the N that
// kernels/longline.py::WIDE lists: as repro_fft_long_*, with `consts`
// longline.constants of the wide plan, seg = N/parts, and `smem_bytes`
// the plan's (longline.WidePlan.smem_bytes).
int repro_fft_wide_c64(const void* x, void* out, const void* consts,
                       const void* tw, long long batch, int n, int inverse,
                       int seg, int smem_bytes, void* stream) {
  return repro_fft::wide_dispatch<float>(n, x, out, consts, tw, batch,
                                         inverse, seg, smem_bytes,
                                         static_cast<cudaStream_t>(stream));
}

int repro_fft_wide_c128(const void* x, void* out, const void* consts,
                        const void* tw, long long batch, int n, int inverse,
                        int seg, int smem_bytes, void* stream) {
  return repro_fft::wide_dispatch<double>(n, x, out, consts, tw, batch,
                                          inverse, seg, smem_bytes,
                                          static_cast<cudaStream_t>(stream));
}

// The split route (kernels/split.py), a line of N = P*Q as (P, Q).
// Pass A: `x` and `y` are contiguous (B, P, Q) blocks; the P-long DFT of
// every column, times the inter-step twiddle from `tables` (TA, P x QL,
// then TB, P x QH; ql_log2 = log2(QL)); `consts` are the radix constants
// of P.  lines_log2 and `smem_bytes`: radix.radix_tile(P, strided)
// without a twiddle.
int repro_fft_split_a_c64(const void* x, void* y, const void* consts,
                          const void* tables, long long batch, int p, int q,
                          int inverse, int lines_log2, int ql_log2,
                          int smem_bytes, void* stream) {
  return repro_fft::radix_dispatch<float, repro_fft::kRadixSplitA>(
      p, x, y, consts, tables, batch, q, inverse, 0, lines_log2, 1, ql_log2,
      smem_bytes, static_cast<cudaStream_t>(stream));
}

int repro_fft_split_a_c128(const void* x, void* y, const void* consts,
                           const void* tables, long long batch, int p, int q,
                           int inverse, int lines_log2, int ql_log2,
                           int smem_bytes, void* stream) {
  return repro_fft::radix_dispatch<double, repro_fft::kRadixSplitA>(
      p, x, y, consts, tables, batch, q, inverse, 0, lines_log2, 1, ql_log2,
      smem_bytes, static_cast<cudaStream_t>(stream));
}

// Pass B on the radix route: `y` holds rows = B*P contiguous rows of Q,
// `out` (parts, B, P*Q/parts) with seg_arg = log2(P*Q/parts) for a
// power-of-two Q, P*Q/parts for a mixed Q, `tw` the
// line's output twiddle (P*Q values) or null, p_log2 = log2(P);
// lines_log2 and `smem_bytes` from radix.radix_tile(Q, lines) without a
// twiddle.
int repro_fft_split_b_radix_c64(const void* y, void* out, const void* consts,
                                const void* tw, long long rows, int q,
                                int inverse, int seg_arg, int lines_log2,
                                int p_log2, int smem_bytes, void* stream) {
  return repro_fft::radix_dispatch<float, repro_fft::kRadixSplitB>(
      q, y, out, consts, tw, rows, 1, inverse, seg_arg, lines_log2, 0,
      p_log2, smem_bytes, static_cast<cudaStream_t>(stream));
}

int repro_fft_split_b_radix_c128(const void* y, void* out, const void* consts,
                                 const void* tw, long long rows, int q,
                                 int inverse, int seg_arg, int lines_log2,
                                 int p_log2, int smem_bytes, void* stream) {
  return repro_fft::radix_dispatch<double, repro_fft::kRadixSplitB>(
      q, y, out, consts, tw, rows, 1, inverse, seg_arg, lines_log2, 0,
      p_log2, smem_bytes, static_cast<cudaStream_t>(stream));
}

// Pass B on the long-line route with pass C folded in (fft_long.cuh's
// split_fold_long_kernel / split_fold_mixed_kernel): `y` holds rows = B*P
// rows of Q (Q of kernels/split.py::FOLD_LONG_ROWS, P = 2^p_log2), `out`
// (parts, B, P*Q/parts) with seg = P*Q/parts, `tw` the line's output
// twiddle (P*Q values) or null; `inverse` scales by 1/(P*Q).  `consts` and
// `smem_bytes` as repro_fft_long_* of Q; `cluster` blocks a cluster (a
// power of two up to 8 that divides P).
int repro_fft_split_b_long_c64(const void* y, void* out, const void* consts,
                               const void* tw, long long rows, int q,
                               int inverse, int p_log2, int seg, int cluster,
                               int smem_bytes, void* stream) {
  return repro_fft::split_fold_dispatch<float>(
      q, y, out, consts, tw, rows, inverse, p_log2, seg, cluster, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

int repro_fft_split_b_long_c128(const void* y, void* out, const void* consts,
                                const void* tw, long long rows, int q,
                                int inverse, int p_log2, int seg,
                                int cluster, int smem_bytes, void* stream) {
  return repro_fft::split_fold_dispatch<double>(
      q, y, out, consts, tw, rows, inverse, p_log2, seg, cluster, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

// Pass B on dense rows with pass C folded in (fft_dense.cuh's
// split_fold_dense_kernel): `y` holds B lines of (P, Q) rows, 16 bytes of
// room past its end; `out` (parts, B, seg); `tw` the line's output twiddle
// or null; `inverse` scales by 1/(P*Q); n_keep > 0 stores only the outputs
// of < n_keep (seg = n_keep/parts, `tw` n_keep values); tile_pitch > 0
// pushes the rows into the cluster's tiles.  `consts` and `ints` are
// dense.constants of Q; the layout's numbers kernels/split.py::
// fold_layout's.
int repro_fft_split_b_dense_c64(
    const void* y, void* out, const void* consts, const void* ints,
    const void* tw, long long lines, int p, int q, int stages,
    int rows_log2, int t_log2, int lo, int n_consts, int n_ints, int buf_off,
    int slot_elems, int depth, int tile_pitch, int inverse, int seg,
    int n_keep, int cluster, int threads, int smem_bytes, void* stream) {
  return repro_fft::split_fold_dense_launch<float>(
      y, out, consts, ints, tw, lines, p, q, stages, rows_log2, t_log2, lo,
      n_consts, n_ints, buf_off, slot_elems, depth, tile_pitch, inverse, seg,
      n_keep, cluster, threads, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

int repro_fft_split_b_dense_c128(
    const void* y, void* out, const void* consts, const void* ints,
    const void* tw, long long lines, int p, int q, int stages,
    int rows_log2, int t_log2, int lo, int n_consts, int n_ints, int buf_off,
    int slot_elems, int depth, int tile_pitch, int inverse, int seg,
    int n_keep, int cluster, int threads, int smem_bytes, void* stream) {
  return repro_fft::split_fold_dense_launch<double>(
      y, out, consts, ints, tw, lines, p, q, stages, rows_log2, t_log2, lo,
      n_consts, n_ints, buf_off, slot_elems, depth, tile_pitch, inverse, seg,
      n_keep, cluster, threads, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

// Pass A of the split route's general plans (kernels/split.py: N = P*Q
// past one block) where N has no power-of-two P for the radix route: the
// dense kernel's column form (fft_dense.cuh, dense_column_kernel) on the
// contiguous (B, P, Q) blocks `x` into `y`, batch = B, n = P, q = Q,
// `lines` columns a block at line pitch `pitch`, `wtab` the inter-step
// twiddle's tables (WA, 2^w_log2 entries, then WB).  `consts` and `ints`
// are dense.constants of P; the layout's numbers and threads
// dense.column_plan's.  Pass B of these plans is repro_fft_split_b_dense_*.
int repro_fft_split_a_dense_c64(const void* x, void* y, const void* consts,
                                const void* ints, const void* wtab,
                                long long batch, int n, int q, int stages,
                                int lines, int pitch, int t_log2, int lo,
                                int n_consts, int n_ints, int buf_off,
                                int inverse, int w_log2, int threads,
                                int smem_bytes, void* stream) {
  return repro_fft::dense_column_launch<float>(
      x, y, consts, ints, wtab, batch, n, q, stages, lines, pitch, t_log2,
      lo, n_consts, n_ints, buf_off, inverse, w_log2, threads, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

int repro_fft_split_a_dense_c128(const void* x, void* y, const void* consts,
                                 const void* ints, const void* wtab,
                                 long long batch, int n, int q, int stages,
                                 int lines, int pitch, int t_log2, int lo,
                                 int n_consts, int n_ints, int buf_off,
                                 int inverse, int w_log2, int threads,
                                 int smem_bytes, void* stream) {
  return repro_fft::dense_column_launch<double>(
      x, y, consts, ints, wtab, batch, n, q, stages, lines, pitch, t_log2,
      lo, n_consts, n_ints, buf_off, inverse, w_log2, threads, smem_bytes,
      static_cast<cudaStream_t>(stream));
}

// Pass C of the plans whose rows run their own launch in natural order
// (kernels/split.py::fold_layout is None: a nested plan's rows on the
// radix, long-line or split route, dense rows too long for the folded
// kernel's slot and tile; they applied the inverse's 1/Q): `z` holds B
// lines of (P, Q) rows (any P and Q), `out` (parts, B, P*Q/parts) with
// seg = P*Q/parts, `tw` the line's output twiddle or null; `inverse`
// scales by 1/P.
int repro_fft_split_c_any_c64(const void* z, void* out, const void* tw,
                              long long lines, int p, int q, int seg,
                              int inverse, void* stream) {
  return repro_fft::split_transpose_any<float>(
      z, out, tw, lines, p, q, seg, inverse,
      static_cast<cudaStream_t>(stream));
}

int repro_fft_split_c_any_c128(const void* z, void* out, const void* tw,
                               long long lines, int p, int q, int seg,
                               int inverse, void* stream) {
  return repro_fft::split_transpose_any<double>(
      z, out, tw, lines, p, q, seg, inverse,
      static_cast<cudaStream_t>(stream));
}

// The chirp route's two transforms (kernels/chirp.py) where M takes the
// dense route: repro_fft_dense_* on lines of n = M whose input lines are
// n_in apart (the first n_in values, zeros past them), times `pre` (the
// input chirp, n_in values; null: not multiplied), and whose outputs k <
// n_out are stored, `out` (parts, B, n_out/parts) with seg =
// n_out/parts.
int repro_fft_dense_chirp_c64(const void* x, void* out, const void* consts,
                              const void* ints, const void* tw,
                              const void* pre, long long batch, int n,
                              int n_in, int n_out, int stages, int lines,
                              int t_log2, int lo, int n_consts, int n_ints,
                              int buf_off, int inverse, int seg, int threads,
                              int smem_bytes, void* stream) {
  return repro_fft::dense_chirp_launch<float>(
      x, out, consts, ints, tw, pre, batch, n, n_in, n_out, stages, lines,
      t_log2, lo, n_consts, n_ints, buf_off, inverse, seg, threads,
      smem_bytes, static_cast<cudaStream_t>(stream));
}

int repro_fft_dense_chirp_c128(const void* x, void* out, const void* consts,
                               const void* ints, const void* tw,
                               const void* pre, long long batch, int n,
                               int n_in, int n_out, int stages, int lines,
                               int t_log2, int lo, int n_consts, int n_ints,
                               int buf_off, int inverse, int seg,
                               int threads, int smem_bytes, void* stream) {
  return repro_fft::dense_chirp_launch<double>(
      x, out, consts, ints, tw, pre, batch, n, n_in, n_out, stages, lines,
      t_log2, lo, n_consts, n_ints, buf_off, inverse, seg, threads,
      smem_bytes, static_cast<cudaStream_t>(stream));
}

// The chirp route's transforms where M is a power of two on the long-line
// route (kernels/longline.py::FOLD_SIZES): fold 1, the first, reads `x`'s
// lines at pitch n_in in pass 1 times `pre`, zeros past n_in, and stores
// the M-long lines (seg_log2 = log2(M)); fold 2, the second, reads M-long
// lines and stores the outputs k < n_out, `out` (parts, B, n_out/parts)
// with fold_seg = n_out/parts.  `consts` and `smem_bytes` as
// repro_fft_long_*.
int repro_fft_long_chirp_c64(const void* x, void* out, const void* consts,
                             const void* tw, const void* pre,
                             long long batch, int n, int fold, int inverse,
                             int seg_log2, int n_in, int n_out, int fold_seg,
                             int smem_bytes, void* stream) {
  return repro_fft::long_chirp_dispatch<float>(
      n, fold, x, out, consts, tw, pre, batch, inverse, seg_log2, n_in,
      n_out, fold_seg, smem_bytes, static_cast<cudaStream_t>(stream));
}

int repro_fft_long_chirp_c128(const void* x, void* out, const void* consts,
                              const void* tw, const void* pre,
                              long long batch, int n, int fold, int inverse,
                              int seg_log2, int n_in, int n_out,
                              int fold_seg, int smem_bytes, void* stream) {
  return repro_fft::long_chirp_dispatch<double>(
      n, fold, x, out, consts, tw, pre, batch, inverse, seg_log2, n_in,
      n_out, fold_seg, smem_bytes, static_cast<cudaStream_t>(stream));
}

// The chirp route's first transform where M = P*Q takes a split plan:
// pass A as repro_fft_split_a_dense_*, `x` B lines of n_in values read as
// the first n_in of each (P, Q) block, times `pre`, zeros past n_in.
int repro_fft_split_a_dense_chirp_c64(
    const void* x, void* y, const void* consts, const void* ints,
    const void* wtab, const void* pre, long long batch, int n, int q,
    int n_in, int stages, int lines, int pitch, int t_log2, int lo,
    int n_consts, int n_ints, int buf_off, int inverse, int w_log2,
    int threads, int smem_bytes, void* stream) {
  return repro_fft::dense_column_chirp_launch<float>(
      x, y, consts, ints, wtab, pre, batch, n, q, n_in, stages, lines, pitch,
      t_log2, lo, n_consts, n_ints, buf_off, inverse, w_log2, threads,
      smem_bytes, static_cast<cudaStream_t>(stream));
}

int repro_fft_split_a_dense_chirp_c128(
    const void* x, void* y, const void* consts, const void* ints,
    const void* wtab, const void* pre, long long batch, int n, int q,
    int n_in, int stages, int lines, int pitch, int t_log2, int lo,
    int n_consts, int n_ints, int buf_off, int inverse, int w_log2,
    int threads, int smem_bytes, void* stream) {
  return repro_fft::dense_column_chirp_launch<double>(
      x, y, consts, ints, wtab, pre, batch, n, q, n_in, stages, lines, pitch,
      t_log2, lo, n_consts, n_ints, buf_off, inverse, w_log2, threads,
      smem_bytes, static_cast<cudaStream_t>(stream));
}

// The chirp route's second transform on a split plan whose rows keep pass
// C: pass C as repro_fft_split_c_any_*, only the outputs of < n_keep = N stored, `out`
// (parts, B, N/parts) with seg = N/parts, `tw` N values.
int repro_fft_split_c_keep_c64(const void* z, void* out, const void* tw,
                               long long lines, int p, int q, int n_keep,
                               int seg, int inverse, void* stream) {
  if (n_keep < 1) return static_cast<int>(cudaErrorInvalidValue);
  return repro_fft::split_transpose_any<float>(
      z, out, tw, lines, p, q, seg, inverse,
      static_cast<cudaStream_t>(stream), n_keep);
}

int repro_fft_split_c_keep_c128(const void* z, void* out, const void* tw,
                                long long lines, int p, int q, int n_keep,
                                int seg, int inverse, void* stream) {
  if (n_keep < 1) return static_cast<int>(cudaErrorInvalidValue);
  return repro_fft::split_transpose_any<double>(
      z, out, tw, lines, p, q, seg, inverse,
      static_cast<cudaStream_t>(stream), n_keep);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif
