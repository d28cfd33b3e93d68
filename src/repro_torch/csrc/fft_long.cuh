// The long-line route of the four-step kernel: lines that fit whole in one
// block's shared memory but not in the radix route's two in-register passes
// (complex64 N = 8192, 16384; complex128 N = 2048, 4096, 8192; the mixed
// N = r*2^k, r in {3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27}, of
// complex64 4352 to 15360 and complex128 1088 to 7680; and the other even
// 13-smooth N that three codelets hold), on Hopper.
//
// Replaces, for these N, the dense contractions of the TPU kernel
// src/repro/kernels/fft_matmul.py::_fft_kernel (and its twiddle and
// pack_parts epilogues), which fft_fourstep.cu's dense kernel ran before:
// 8*N*(N1+N2) flops per line, one line per block, W2 streamed from L2.
//
// What bounds it on an H100: a length-N DFT needs about 5*log2(N) flops
// per element against 16 bytes of complex64 moved (about 4 flops per
// byte at N = 8192), far below the 20 at which the fp32 CUDA cores and
// HBM (3.35 TB/s) break even.  So HBM bytes bound it, and the design
// reads every byte once and writes it once:
//  * One line per block in shared memory, transformed in three passes
//    over N = R1*R2*R3 (kernels/longline.py::FACTORS), each an in-register
//    radix-2 codelet of at most 32 values (fft_radix.cuh's fft_stages and
//    static_for), so ptxas keeps every value in registers.
//  * The line arrives by one bulk asynchronous copy (cp.async.bulk, TMA)
//    that a single thread issues, completing on an mbarrier; the other
//    threads spend no registers on addresses.  A ring of DEPTH line
//    buffers (2 where two fit, else 1: long_depth) and a persistent grid:
//    as soon as the last pass has read a buffer, the copy of the block's
//    line after next (DEPTH = 2) or next (DEPTH = 1) into it starts, so
//    loads overlap the transforms.
//  * Pass 1 reads the line in natural order and writes in place; pass 2
//    writes the layout (m3, kA) with a row pitch of R1*R2 + 1, so every
//    shared-memory access of a warp hits consecutive addresses or distinct
//    banks; pass 3's items are consecutive output indices, so its stores
//    (the epilogue: output twiddle, 1/N, pack_parts segment) cover whole
//    sectors of HBM.
//  * The inter-pass twiddles W_N^(k1*mb) come from a two-level table,
//    TA[k1, m3] * TB[k1, m2] (mb = m2*R3 + m3), and W_(R2*R3)^(k2*m3) from
//    TC: R1*R3 + R1*R2 + R2*R3 entries, not N, built in float64 on the host
//    (kernels/fft_matmul.py::_long_constants) and kept in shared memory.
//    Threads of a warp read consecutive entries of TA and TC and one of TB.
// Mixed lengths (long_mixed_kernel, below): one factor, R1 = r*2^a (odd
// for r = 17, 19, 21, 23, 25, 27), runs the radix route's mixed chain
// (codelet, load_slot) on its own table of R1 entries; R2 and R3 are powers
// of two.  The line is copied in R1 rows
// of N/R1 at a pitch of N/R1 plus 16 bytes (R1 bulk copies on one
// mbarrier), and each pass transforms one item at a time and stores it
// where it was read, (k1, m2, m3) then (k1, k2, m3), so no pass needs its
// items to split evenly over the threads: the block has a fixed count
// sized for occupancy (long_mixed_threads: 256 for complex64, 128 or 256
// for complex128), each pass walks its items in rounds of the block and
// the last round leaves some threads idle.  A ring of two line buffers
// where two fit (long_mixed_depth), as long_kernel's.  Pass 3's reads of
// consecutive kA fall R1 rows apart, on distinct banks (complex64 reads
// two values at once, 16 bytes), and its stores cover consecutive outputs.
// kernels/longline.py holds the same plan and index maps in Python
// (longline.emulate is the kernel's plain version).
//
// The split route (kernels/split.py) runs its long rows (a Q of this
// route) through the same bodies with the line's transposed store folded
// in (split_fold_long_kernel, split_fold_mixed_kernel, below: the kFoldSplit
// mode).  A block holds one row here, so its stores alone cannot be staged
// for a warp to write consecutive kp as the radix route's pass B does:
// stored straight to kp + P*kq, 8 bytes P elements apart, they made a
// split of 2^24 complex64 take 3.8 ms, against 1.5 for the rows in place
// and a transpose pass (PERF.md).  A thread-block cluster of C blocks on
// neighbouring SMs transforms C consecutive rows kp, one a block, keeps
// each in its shared memory, and each block then reads its share of kq
// from all C rows through distributed shared memory and stores runs of C
// consecutive outputs (split_fold_store): two HBM passes, not three.
#pragma once

#include <cstdint>

#include "fft_common.cuh"
#include "fft_radix.cuh"

namespace repro_fft {

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory one block may take (227 KB), and an SM's with
// what the runtime reserves per block.
constexpr size_t kLongSmemMax = 232448;
constexpr size_t kSmemPerSm = 233472, kSmemReserved = 1024;

template <int R1, int R2, int R3>
struct LongShape {
  static constexpr int N = R1 * R2 * R3;
  static constexpr int RM = cmax(R1, cmax(R2, R3));
  static constexpr int THREADS = N / RM;   // each holds RM values a pass
  static constexpr int Q = R1 * R2;        // pass-3 items
  static constexpr int PITCH = Q + 1;      // row pitch of pass 2's output
  static constexpr int LINE = R3 * PITCH;  // elements of one line buffer
  static constexpr int CONSTS = R1 * R3 + R1 * R2 + R2 * R3 + RM / 2;
};

// Shared memory of one block: the ring's line buffers, the constants, one
// mbarrier per buffer (kernels/longline.py::smem_bytes).
template <typename R, int R1, int R2, int R3, int DEPTH>
__host__ __device__ constexpr size_t long_smem_bytes() {
  using S = LongShape<R1, R2, R3>;
  return (size_t)(DEPTH * S::LINE + S::CONSTS) * sizeof(cpx<R>) +
         DEPTH * sizeof(uint64_t);
}

// The kernel's launch bound in blocks per SM, so that ptxas fits its
// registers to them: for complex64 the blocks an SM holds by shared
// memory (228 KB, 1 KB reserved per block), at least 1 and at most 2 (128
// registers a thread for two blocks of 256); for complex128, whose values
// and twiddles take twice the registers, 1.  Without a bound ptxas
// spilled complex128 16x16x16 at 128 registers, and with two blocks too.
template <typename R, int R1, int R2, int R3, int DEPTH>
__host__ __device__ constexpr int long_min_blocks() {
  constexpr size_t fit =
      kSmemPerSm / (long_smem_bytes<R, R1, R2, R3, DEPTH>() + kSmemReserved);
  if (sizeof(R) != sizeof(float)) return 1;
  return fit < 1 ? 1 : (fit > 2 ? 2 : (int)fit);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global to shared memory by the TMA unit, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The cluster's rank of this block, the cluster's blocks, and a barrier
// of every thread of every block of the cluster (release, then acquire:
// each block's shared-memory writes before it are seen by the others'
// reads after it).  A launch without a cluster is a cluster of one block.
__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The address of *p (this block's shared memory) in the shared memory of
// the cluster's block `rank`, as a generic address.
template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, unsigned rank) {
  unsigned long long a;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(a)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<T*>(a);
}

// An arrival on `bar` with no bytes to wait for: completes the phase of a
// ring slot that a group's masked rows leave without a copy.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Items of split_fold_store a thread has in flight at once.
constexpr int kFoldItems = 4;

// A cluster block's share of kq of Q in split_fold_store: [rank*S,
// (rank+1)*S) within Q, S = ceil(Q/C) (kernels/split.py::fold_emulate).
__device__ __forceinline__ int fold_share(int q, int csize) {
  return (q + csize - 1) / csize;
}

// The split route's pass B with pass C folded in (kernels/split.py::
// fold_layout, fold_emulate): a group of G = 2^g_log2 consecutive rows kp0
// + j, j < G, of line b, spread over the cluster's blocks, each block's
// rows transformed in its shared memory; the first nj of them are rows of
// the line (a ragged P leaves the last group short).  After a cluster
// barrier, block `rank` stores its share of kq, `count` of them, the t-th
// kq_of(t) (by default [rank*S, (rank+1)*S) within Q, S = ceil(Q/C):
// fold_share), of every row of the group, `at(j, kq)` reading output kq
// of row j wherever the cluster keeps it: consecutive threads take
// consecutive j, so a warp writes runs of G consecutive outputs of = kp0 +
// j + P*kq, each with pass C's
// epilogues in its order: the output twiddle gtw[of], `scale` (the
// inverse's 1/(P*Q)), the pack_parts segment of length `seg` (`out` is
// (parts, lines, seg)); with kKeep (the chirp route's second transform)
// only the outputs of < n_keep.
//
// U items a thread at once (kFoldItems where the reads come from another
// block's shared memory: all are issued before any is used; 1 where they
// are local).
template <bool kKeep, int U = kFoldItems, typename R, typename At,
          typename KqOf>
__device__ __forceinline__ void split_fold_store(
    At at, KqOf kq_of, int count, cpx<R>* __restrict__ out,
    const cpx<R>* __restrict__ gtw, long long lines, long long b, int p,
    int kp0, int g_log2, int nj, int seg, float inv_seg, R scale,
    int n_keep) {
  const int gmask = (1 << g_log2) - 1;
  const int items = count << g_log2;
  const int step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < items; i0 += U * step) {
    cpx<R> y[U];
    int of[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * step;
      const int j = i & gmask;
      const int kq = kq_of(i >> g_log2);
      of[u] = kp0 + j + kq * p;  // < P*Q < 2^31
      ok[u] = i < items && j < nj && (!kKeep || of[u] < n_keep);
      if (ok[u]) y[u] = at(j, kq);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      cpx<R> v = y[u];
      if (gtw != nullptr) v = cmul(v, gtw[of[u]]);
      v.re *= scale;
      v.im *= scale;
      const int part = div_small(of[u], seg, inv_seg);
      out[((long long)part * lines + b) * seg + (of[u] - part * seg)] = v;
    }
  }
}

// The chirp route's folded load and store (kernels/chirp.py) on this
// kernel: kFoldIn, the first transform, copies x's line at pitch n_in
// into the line buffer by plain loads (no bulk copy: an odd N's lines do
// not start on 16 bytes), times `pre` (the input chirp, n_in values),
// zeros past n_in, and pass 1 reads it there (reading global memory in
// pass 1 itself spilled at complex64 16x32x32); kFoldOut, the second,
// stages pass 3's outputs in the buffer and stores only the outputs o <
// n_out, `out` (parts, batch, n_out/parts) with seg = n_out/parts of any
// length and `gtw` n_out values, before the next line's bulk copy.
// kFoldSplit, the split route's long rows (split_fold_long_kernel), stages
// pass 3's outputs in the buffer in natural order, then stores the
// cluster's group of rows transposed (split_fold_store) and copies the
// block's next row in after a second cluster barrier.
constexpr int kFoldNone = 0, kFoldIn = 1, kFoldOut = 2, kFoldSplit = 3;

// `out` is (parts, batch, N/parts) with seg_log2 = log2(N/parts); `gtw`
// (the output twiddle, N values) may be null.  The grid is persistent:
// block b takes lines b, b + gridDim.x, ...  FOLD (kFoldNone for
// long_kernel, whose SASS it keeps) as above; with kFoldSplit `x` holds
// batch = B*P rows of the split route's lines (P = 2^p_log2, a multiple of
// the cluster's size, which divides gridDim.x: a cluster's blocks take
// consecutive rows), `out` is (parts, B, fold_seg).
template <typename R, int R1, int R2, int R3, int DEPTH, int FOLD>
__device__ __forceinline__ void long_body(
    const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
    const cpx<R>* __restrict__ consts, const cpx<R>* __restrict__ gtw,
    long long batch, int inverse, int seg_log2,
    const cpx<R>* __restrict__ pre, int n_in, int n_out, int fold_seg,
    int p_log2 = 0) {
  using S = LongShape<R1, R2, R3>;
  constexpr int N = S::N, RM = S::RM, T = S::THREADS, Q = S::Q;
  constexpr int PITCH = S::PITCH, M1 = N / R1;
  constexpr unsigned kLineBytes = N * sizeof(cpx<R>);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cpx<R>* const bufs = reinterpret_cast<cpx<R>*>(smem_raw);
  cpx<R>* const ta = bufs + DEPTH * S::LINE;
  const cpx<R>* const tb = ta + R1 * R3;
  const cpx<R>* const tc = tb + R1 * R2;
  const cpx<R>* const w = tc + R2 * R3;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(ta + S::CONSTS);
  const int tid = threadIdx.x;

  for (int i = tid; i < S::CONSTS; i += T) ta[i] = consts[i];
  if (tid == 0) {
    for (int d = 0; d < DEPTH; ++d) mbar_init(&bars[d], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long stride = gridDim.x;
  if (FOLD != kFoldIn && tid == 0) {
    for (int d = 0; d < DEPTH; ++d) {
      const long long line = blockIdx.x + d * stride;
      if (line < batch)
        bulk_load(bufs + d * S::LINE, x + line * N, kLineBytes, &bars[d]);
    }
  }
  // 1/N folded at compile time: a run-time double division would call a
  // subroutine that needs a stack frame.
  constexpr R kInvN = R(1) / R(N);
  const R scale = inverse ? kInvN : R(1);
  const int seg = 1 << seg_log2;
  const float inv_fold_seg = FOLD == kFoldOut || FOLD == kFoldSplit
                                 ? 1.0f / static_cast<float>(fold_seg)
                                 : 0.0f;

  int slot = 0;
  unsigned parity = 0;
  for (long long line = blockIdx.x; line < batch; line += stride) {
    cpx<R>* const s = bufs + slot * S::LINE;
    if constexpr (FOLD == kFoldIn) {
      // the line from global memory at pitch n_in, times the chirp,
      // zeros past n_in (pass 1 then runs as it does on a bulk copy)
      const cpx<R>* const xl = x + line * n_in;
#pragma unroll 8
      for (int e = tid; e < N; e += T) {
        cpx<R> y;
        y.re = R(0);
        y.im = R(0);
        if (e < n_in) y = cmul(xl[e], pre[e]);
        s[e] = y;
      }
      __syncthreads();
    } else {
      mbar_wait(&bars[slot], parity);
    }

    // Pass 1: item mb = m2*R3 + m3 reads x[m1*M1 + mb], writes in place.
    auto pass1 = [&](auto it) {
      const int mb = tid + decltype(it)::value * T;
      const int m2 = mb / R3, m3 = mb % R3;
      cpx<R> v[R1];
      auto load = [&](auto i) {
        constexpr int m1 = decltype(i)::value;
        constexpr int at = bitrev(m1, ilog2(R1));
        v[at] = s[m1 * M1 + mb];
      };
      static_for<0, R1>(load);
      fft_stages<R1, RM, 2, R>(v, w);
      auto store = [&](auto i) {
        constexpr int k1 = decltype(i)::value;
        cpx<R> y = v[k1];
        if constexpr (k1 != 0)
          y = cmul(y, cmul(ta[k1 * R3 + m3], tb[k1 * R2 + m2]));
        s[k1 * M1 + mb] = y;
      };
      static_for<0, R1>(store);
    };
    static_for<0, RM / R1>(pass1);
    __syncthreads();

    // Pass 2: item (k1, m3); its values move to (m3, kA), so every value
    // is loaded before any is stored.
    {
      constexpr int I2 = RM / R2;
      cpx<R> v[I2][R2];
      auto load_item = [&](auto it) {
        constexpr int i = decltype(it)::value;
        const int item = tid + i * T;
        const int k1 = item / R3, m3 = item % R3;
        auto load = [&](auto j) {
          constexpr int m2 = decltype(j)::value;
          constexpr int at = bitrev(m2, ilog2(R2));
          v[i][at] = s[k1 * M1 + m2 * R3 + m3];
        };
        static_for<0, R2>(load);
      };
      static_for<0, I2>(load_item);
      __syncthreads();
      auto store_item = [&](auto it) {
        constexpr int i = decltype(it)::value;
        const int item = tid + i * T;
        const int k1 = item / R3, m3 = item % R3;
        fft_stages<R2, RM, 2, R>(v[i], w);
        auto store = [&](auto j) {
          constexpr int k2 = decltype(j)::value;
          cpx<R> y = v[i][k2];
          if constexpr (k2 != 0) y = cmul(y, tc[k2 * R3 + m3]);
          s[m3 * PITCH + k1 + R1 * k2] = y;
        };
        static_for<0, R2>(store);
      };
      static_for<0, I2>(store_item);
    }
    __syncthreads();

    // Pass 3: item kA = k1 + R1*k2 reads (m3, kA); once every thread has
    // read the buffer, it takes the next line's copy.
    constexpr int I3 = RM / R3;
    cpx<R> v[I3][R3];
    auto load_item = [&](auto it) {
      constexpr int i = decltype(it)::value;
      const int ka = tid + i * T;
      auto load = [&](auto j) {
        constexpr int m3 = decltype(j)::value;
        constexpr int at = bitrev(m3, ilog2(R3));
        v[i][at] = s[m3 * PITCH + ka];
      };
      static_for<0, R3>(load);
    };
    static_for<0, I3>(load_item);
    // The buffer's generic-proxy reads and writes are ordered before the
    // bulk copy (async proxy) that overwrites it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (FOLD == kFoldNone && tid == 0) {
      const long long next = line + DEPTH * stride;
      if (next < batch) bulk_load(s, x + next * N, kLineBytes, &bars[slot]);
    }
    auto store_item = [&](auto it) {
      constexpr int i = decltype(it)::value;
      const int ka = tid + i * T;
      fft_stages<R3, RM, 2, R>(v[i], w);
      auto store = [&](auto j) {
        constexpr int k3 = decltype(j)::value;
        const int o = ka + Q * k3;
        cpx<R> y = v[i][k3];
        if constexpr (FOLD == kFoldOut || FOLD == kFoldSplit) {
          s[o] = y;  // staged in natural order, stored below
          return;
        }
        if (gtw != nullptr) y = cmul(y, gtw[o]);
        y.re *= scale;
        y.im *= scale;
        if (seg >= Q) {
          // A segment holds whole runs of Q outputs: the run's address is
          // the same for every thread, and ka indexes into it.  (With the
          // general form alone ptxas spilled at 255 registers for
          // complex128 16x16x32.)
          constexpr int o0 = Q * k3;
          const long long run =
              (((long long)(o0 >> seg_log2) * batch + line) << seg_log2) +
              (o0 & (seg - 1));
          out[run + ka] = y;
        } else {
          out[(((long long)(o >> seg_log2) * batch + line) << seg_log2) +
              (o & (seg - 1))] = y;
        }
      };
      static_for<0, R3>(store);
    };
    static_for<0, I3>(store_item);
    if constexpr (FOLD == kFoldOut) {
      // The outputs o < n_out from the buffer, with the epilogues, in
      // segments of any length (a store per output from registers,
      // with its segment's arithmetic, spilled at complex64 16x32x32).
      __syncthreads();
      cpx<R>* const ol = out + line * fold_seg;
      const long long plane = batch * fold_seg;
      for (int o = tid; o < n_out; o += T) {
        cpx<R> y = s[o];
        if (gtw != nullptr) y = cmul(y, gtw[o]);
        y.re *= scale;
        y.im *= scale;
        // o / fold_seg in fp32, exact for o < 2^22 (the radix route's
        // plain store)
        const int part = __float2int_rz(((float)o + 0.5f) * inv_fold_seg);
        ol[part * plane + o - part * fold_seg] = y;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        const long long next = line + DEPTH * stride;
        if (next < batch)
          bulk_load(s, x + next * N, kLineBytes, &bars[slot]);
      }
    }
    if constexpr (FOLD == kFoldSplit) {
      // The cluster's rows row0 + j, j < C, of line b, kp0 = row0 mod P:
      // this block stores its share of kq of all of them.
      cluster_sync_all();
      const unsigned rank = cluster_ctarank(), csize = cluster_nctarank();
      const long long row0 = line - rank;
      const R split_scale = inverse ? kInvN * pow2_neg<R>(p_log2) : R(1);
      const int share = fold_share(N, csize);
      split_fold_store<false>(
          [&](int j, int kq) { return *cluster_map(s + kq, j); },
          [&](int t) { return (int)rank * share + t; }, share, out, gtw,
          batch >> p_log2, row0 >> p_log2, 1 << p_log2,
          (int)(row0 & ((1 << p_log2) - 1)), __ffs(csize) - 1, csize,
          fold_seg, inv_fold_seg, split_scale, 0);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      cluster_sync_all();  // every block has read the rows it stores
      if (tid == 0) {
        const long long next = line + DEPTH * stride;
        if (next < batch)
          bulk_load(s, x + next * N, kLineBytes, &bars[slot]);
      }
    }
    if (++slot == DEPTH) {
      slot = 0;
      parity ^= 1;
    }
  }
}

template <typename R, int R1, int R2, int R3, int DEPTH>
__global__ void __launch_bounds__(
    LongShape<R1, R2, R3>::THREADS,
    (long_min_blocks<R, R1, R2, R3, DEPTH>()))
long_kernel(const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
            const cpx<R>* __restrict__ consts,
            const cpx<R>* __restrict__ gtw, long long batch, int inverse,
            int seg_log2) {
  long_body<R, R1, R2, R3, DEPTH, kFoldNone>(
      x, out, consts, gtw, batch, inverse, seg_log2,
      static_cast<const cpx<R>*>(nullptr), 0, 0, 1);
}

// The chirp route's transforms of a power-of-two M on this route: FOLD
// kFoldIn (the first) or kFoldOut (the second).
template <typename R, int R1, int R2, int R3, int DEPTH, int FOLD>
__global__ void __launch_bounds__(
    LongShape<R1, R2, R3>::THREADS,
    (long_min_blocks<R, R1, R2, R3, DEPTH>()))
long_chirp_kernel(const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
                  const cpx<R>* __restrict__ consts,
                  const cpx<R>* __restrict__ gtw,
                  const cpx<R>* __restrict__ pre, long long batch,
                  int inverse, int seg_log2, int n_in, int n_out,
                  int fold_seg) {
  long_body<R, R1, R2, R3, DEPTH, FOLD>(x, out, consts, gtw, batch, inverse,
                                        seg_log2, pre, n_in, n_out,
                                        fold_seg);
}

// Launches a long-line kernel (long_kernel or long_mixed_kernel, whose
// parameters are the same) on a persistent grid: as many blocks as fit on
// the SMs, at most one per line.  `layout_bytes` is the kernel's shared
// memory, which the wrapper's layout (kernels/longline.py) must match.
template <typename R, typename Kernel>
int long_launch(Kernel kernel, int threads, size_t layout_bytes,
                const void* x, void* out, const void* consts, const void* tw,
                long long batch, int inverse, int seg_arg, int smem_bytes,
                cudaStream_t stream) {
  if ((size_t)smem_bytes != layout_bytes) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > batch) grid = batch;
  kernel<<<(unsigned)grid, threads, (size_t)smem_bytes, stream>>>(
      static_cast<const cpx<R>*>(x), static_cast<cpx<R>*>(out),
      static_cast<const cpx<R>*>(consts), static_cast<const cpx<R>*>(tw),
      batch, inverse, seg_arg);
  return (int)cudaGetLastError();
}

// A three-pass plan of codelets (kernels/longline.py::LongPlan of a mixed
// length, or WidePlan): N = R1*R2*R3, R3 a power of two, R1 and R2 each a
// power of two or (MIXED1, MIXED2) the radix route's mixed chain on a table
// of its own (R1's first, then R2's).  A mixed long line has R1 = r*2^a
// mixed; the wide lines (fft_wide.cuh) take either.
template <typename R, int R1, int R2, int R3>
struct LongMixedShape {
  static constexpr int N = R1 * R2 * R3;
  static constexpr int M1 = R2 * R3;          // a row: pass-1 items
  static constexpr bool MIXED1 = !is_pow2(R1), MIXED2 = !is_pow2(R2);
  // the radix-2 codelets' table: the largest power-of-two factor
  static constexpr int RP =
      cmax(MIXED1 ? 2 : R1, cmax(MIXED2 ? 2 : R2, R3));
  static constexpr int PITCH = M1 + 16 / (int)sizeof(cpx<R>);
  static constexpr int LINE = R1 * PITCH;
  static constexpr int CONSTS = R1 * R3 + R1 * R2 + R2 * R3 + RP / 2 +
                                (MIXED1 ? R1 : 0) + (MIXED2 ? R2 : 0);
  static_assert(is_pow2(R3) && R3 >= 2, "R3 a power of two");
};

// Shared memory of one block: the ring's DEPTH buffers of LT lines, the
// constants, one mbarrier per buffer (kernels/longline.py::smem_bytes,
// WidePlan.smem_bytes).
template <typename R, int R1, int R2, int R3, int DEPTH, int LT = 1>
__host__ __device__ constexpr size_t long_mixed_smem_bytes() {
  using S = LongMixedShape<R, R1, R2, R3>;
  return (size_t)(DEPTH * LT * S::LINE + S::CONSTS) * sizeof(cpx<R>) +
         DEPTH * sizeof(uint64_t);
}

// Two line buffers where they fit in a block's 227 KB, else one
// (kernels/longline.py::LongPlan.depth).
template <typename R, int R1, int R2, int R3>
__host__ __device__ constexpr int long_mixed_depth() {
  return long_mixed_smem_bytes<R, R1, R2, R3, 2>() <= kLongSmemMax ? 2 : 1;
}

// Blocks an SM holds by shared memory, at that depth.
template <typename R, int R1, int R2, int R3>
__host__ __device__ constexpr int long_mixed_fit() {
  constexpr int fit = (int)(kSmemPerSm /
                            (long_mixed_smem_bytes<R, R1, R2, R3,
                                                   long_mixed_depth<R, R1, R2,
                                                                    R3>()>() +
                             kSmemReserved));
  return fit < 1 ? 1 : fit;
}

// Threads of a block (kernels/longline.py::LongPlan.threads): 256 for
// complex64; complex128's codelets take up to 255 registers a thread, so
// one block of 256 fills an SM's registers: 128 where two blocks share the
// SM by shared memory (one's copy overlaps the other's passes), else 256.
template <typename R, int R1, int R2, int R3>
__host__ __device__ constexpr int long_mixed_threads() {
  if (sizeof(R) == sizeof(float)) return 256;
  return long_mixed_fit<R, R1, R2, R3>() >= 2 ? 128 : 256;
}

// Blocks per SM for the launch bound: as many as shared memory holds, but
// no fewer registers a thread than complex64 needs for a 32-value codelet
// (128) or complex128 (255: the radix route's 30x32 takes 180).
template <typename R, int R1, int R2, int R3>
__host__ __device__ constexpr int long_mixed_min_blocks() {
  constexpr int fit = long_mixed_fit<R, R1, R2, R3>();
  constexpr int regs = sizeof(R) == sizeof(float) ? 128 : 255;
  constexpr int by_regs = 65536 / (long_mixed_threads<R, R1, R2, R3>() * regs);
  constexpr int m = fit < by_regs ? fit : by_regs;
  return m < 1 ? 1 : m;
}

// a, b = p[0], p[1] in one 16-byte load (p 16-byte aligned).
template <typename R>
__device__ __forceinline__ void load_pair(const cpx<R>* p, cpx<R>& a,
                                          cpx<R>& b) {
  if constexpr (sizeof(R) == sizeof(float)) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    a.re = q.x;
    a.im = q.y;
    b.re = q.z;
    b.im = q.w;
  } else {
    a = p[0];
    b = p[1];
  }
}

// One thread: a line's R1 rows of M1 elements from global memory into the
// buffer at a row pitch of PITCH, by the TMA unit, completing on `bar`.
template <typename R, int R1, int M1, int PITCH>
__device__ __forceinline__ void bulk_load_rows(cpx<R>* dst,
                                               const cpx<R>* src,
                                               uint64_t* bar) {
  constexpr unsigned kRowBytes = M1 * sizeof(cpx<R>);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(R1 * kRowBytes)
               : "memory");
  for (int m1 = 0; m1 < R1; ++m1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst + m1 * PITCH)),
        "l"(src + m1 * M1), "r"(kRowBytes), "r"(smem_addr(bar))
        : "memory");
  }
}

// The rows of a buffer of `lines` consecutive lines, by the TMA unit,
// completing on `bar`: LANES = 1, thread 0 copies one line
// (bulk_load_rows); LANES = 32, warp 0 shares a tile's rows after lane 0
// arms the barrier with their bytes.
template <typename R, int R1, int M1, int PITCH, int LANES>
__device__ __forceinline__ void load_tile(cpx<R>* dst, const cpx<R>* src,
                                          int lines, uint64_t* bar,
                                          int lane) {
  if constexpr (LANES == 1) {
    bulk_load_rows<R, R1, M1, PITCH>(dst, src, bar);
  } else {
    constexpr unsigned kRowBytes = M1 * sizeof(cpx<R>);
    constexpr int LINE = R1 * PITCH;
    if (lane == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(bar)),
          "r"((unsigned)lines * R1 * kRowBytes)
          : "memory");
    __syncwarp();
    for (int r = lane; r < lines * R1; r += LANES) {
      const int l = r / R1, m1 = r - l * R1;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst + l * LINE +
                                                    m1 * PITCH)),
          "l"(src + l * (R1 * M1) + m1 * M1), "r"(kRowBytes),
          "r"(smem_addr(bar))
          : "memory");
    }
  }
}

// The body of long_mixed_kernel and wide_kernel (fft_wide.cuh): T threads,
// tiles of LT consecutive lines (the last may hold fewer) in a ring of
// DEPTH buffers, each copied by LANES threads (load_tile), the grid
// persistent (block b takes tiles b, b + gridDim.x, ...).  Three passes of
// codelets, each walking its LT*N/R_i items in rounds of the block and
// storing each item where it was read; pass 3's items are consecutive
// outputs kA of a line, stored with the epilogue.  `out` is (parts,
// batch, seg) with seg = N/parts; the sign of the mixed codelets'
// rotations is read from their table (W_R1^1 or W_R2^1), so that the
// split route's pass B, launched with inverse = 0 to leave out the 1/N,
// keeps it.  With kSplit (split_fold_mixed_kernel: one line a tile) `x`
// holds batch = B*P rows of the split route's lines, P = 2^p_log2, and
// pass 3 leaves each item's outputs where it read its inputs (output o =
// kA + Q*k3 at (k1, k2, k3)); the cluster's group of rows is then stored
// transposed (split_fold_store), `out` (parts, B, seg), as long_body's
// kFoldSplit.
template <typename R, int R1, int R2, int R3, int LT, int T, int DEPTH,
          int LANES, bool kSplit = false>
__device__ __forceinline__ void mixed_tiles(
    const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
    const cpx<R>* __restrict__ consts, const cpx<R>* __restrict__ gtw,
    long long batch, int inverse, int seg, int p_log2 = 0) {
  using S = LongMixedShape<R, R1, R2, R3>;
  constexpr int N = S::N, M1 = S::M1, RP = S::RP, PITCH = S::PITCH;
  constexpr int LINE = S::LINE, TILE = LT * LINE, Q = R1 * R2;
  static_assert(LANES == 32 || LT == 1, "one thread copies one line");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cpx<R>* const bufs = reinterpret_cast<cpx<R>*>(smem_raw);
  cpx<R>* const ta = bufs + DEPTH * TILE;
  const cpx<R>* const tb = ta + R1 * R3;
  const cpx<R>* const tc = tb + R1 * R2;
  const cpx<R>* const w = tc + R2 * R3;   // W_RP^j, j < RP/2
  const cpx<R>* const wm = w + RP / 2;    // W_R1^j, j < R1 (MIXED1)
  const cpx<R>* const wm2 = wm + (S::MIXED1 ? R1 : 0);  // W_R2 (MIXED2)
  uint64_t* const bars = reinterpret_cast<uint64_t*>(ta + S::CONSTS);
  const int tid = threadIdx.x;
  const long long tiles = (batch + LT - 1) / LT;

  for (int i = tid; i < S::CONSTS; i += T) ta[i] = consts[i];
  if (tid == 0) {
    for (int d = 0; d < DEPTH; ++d) mbar_init(&bars[d], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long stride = gridDim.x;
  // Lines of tile t: LT, or what is left of the batch.
  auto tile_lines = [&](long long t) {
    if constexpr (LT == 1) return 1;
    const long long left = batch - t * LT;
    return left < LT ? (int)left : LT;
  };
  if (LANES == 1 ? tid == 0 : tid < LANES) {
    for (int d = 0; d < DEPTH; ++d) {
      const long long t = blockIdx.x + d * stride;
      if (t < tiles)
        load_tile<R, R1, M1, PITCH, LANES>(bufs + d * TILE, x + t * LT * N,
                                           tile_lines(t), &bars[d], tid);
    }
  }
  R sgn = R(1);
  if constexpr (S::MIXED1)
    sgn = wm[1].im > R(0) ? R(1) : R(-1);
  else if constexpr (S::MIXED2)
    sgn = wm2[1].im > R(0) ? R(1) : R(-1);
  constexpr R kInvN = R(1) / R(N);
  const R scale = inverse ? kInvN : R(1);
  // o / seg in fp32, exact for o < N < 2^20 (fft_radix.cuh's plain store)
  const float inv_seg = __fdividef(1.0f, (float)seg);

  int slot = 0;
  unsigned parity = 0;
  for (long long t = blockIdx.x; t < tiles; t += stride) {
    cpx<R>* const s = bufs + slot * TILE;
    const int lines = tile_lines(t);
    mbar_wait(&bars[slot], parity);

    // Pass 1: item (l, mb), mb = m2*R3 + m3, reads (l, m1, mb), writes
    // (l, k1, mb).
#pragma unroll 1
    for (int it = tid; it < lines * M1; it += T) {
      const int l = LT == 1 ? 0 : it / M1, mb = it - l * M1;
      const int m2 = mb / R3, m3 = mb % R3;
      cpx<R>* const row = s + l * LINE + mb;
      cpx<R> v[R1];
      auto load = [&](auto j) {
        constexpr int m1 = decltype(j)::value;
        v[load_slot(R1, m1)] = row[m1 * PITCH];
      };
      static_for<0, R1>(load);
      if constexpr (S::MIXED1)
        codelet<R1, R1, R>(v, wm, sgn);
      else
        codelet<R1, RP, R>(v, w, sgn);
      auto store = [&](auto j) {
        constexpr int k1 = decltype(j)::value;
        cpx<R> y = v[k1];
        if constexpr (k1 != 0)
          y = cmul(y, cmul(ta[k1 * R3 + m3], tb[k1 * R2 + m2]));
        row[k1 * PITCH] = y;
      };
      static_for<0, R1>(store);
    }
    __syncthreads();

    // Pass 2: item (l, k1, m3) reads (l, k1, m2, m3), writes (l, k1, k2,
    // m3).
#pragma unroll 1
    for (int it = tid; it < lines * (R1 * R3); it += T) {
      const int l = LT == 1 ? 0 : it / (R1 * R3), item = it - l * R1 * R3;
      const int k1 = item / R3, m3 = item % R3;
      cpx<R>* const col = s + l * LINE + k1 * PITCH + m3;
      cpx<R> v[R2];
      auto load = [&](auto j) {
        constexpr int m2 = decltype(j)::value;
        v[load_slot(R2, m2)] = col[m2 * R3];
      };
      static_for<0, R2>(load);
      if constexpr (S::MIXED2)
        codelet<R2, R2, R>(v, wm2, sgn);
      else
        codelet<R2, RP, R>(v, w, sgn);
      auto store = [&](auto j) {
        constexpr int k2 = decltype(j)::value;
        cpx<R> y = v[k2];
        if constexpr (k2 != 0) y = cmul(y, tc[k2 * R3 + m3]);
        col[k2 * R3] = y;
      };
      static_for<0, R2>(store);
    }
    __syncthreads();

    // Pass 3: item (l, kA), kA = k1 + R1*k2, reads (l, k1, k2, m3) and
    // stores out[kA + Q*k3] of line t*LT + l with the epilogue.
#pragma unroll 1
    for (int it = tid; it < lines * Q; it += T) {
      const int l = LT == 1 ? 0 : it / Q, ka = it - l * Q;
      const int k2 = ka / R1, k1 = ka - k2 * R1;
      const cpx<R>* const run = s + l * LINE + k1 * PITCH + k2 * R3;
      cpx<R> v[R3];
      auto load = [&](auto j) {
        constexpr int m3 = 2 * decltype(j)::value;
        load_pair(run + m3, v[bitrev(m3, ilog2(R3))],
                  v[bitrev(m3 + 1, ilog2(R3))]);
      };
      static_for<0, R3 / 2>(load);
      fft_stages<R3, RP, 2, R>(v, w);
      if constexpr (kSplit) {
        cpx<R>* const stage = s + l * LINE + k1 * PITCH + k2 * R3;
        auto keep = [&](auto j) {
          constexpr int k3 = decltype(j)::value;
          stage[k3] = v[k3];
        };
        static_for<0, R3>(keep);
        continue;
      }
      const long long line = t * LT + l;
      auto store = [&](auto j) {
        constexpr int k3 = decltype(j)::value;
        const int o = ka + Q * k3;
        cpx<R> y = v[k3];
        if (gtw != nullptr) y = cmul(y, gtw[o]);
        y.re *= scale;
        y.im *= scale;
        const int part = __float2int_rz(((float)o + 0.5f) * inv_seg);
        out[((long long)part * batch + line) * seg + (o - part * seg)] = y;
      };
      static_for<0, R3>(store);
    }
    if constexpr (kSplit) {
      // The cluster's rows row0 + j, j < C, of line b (as long_body's
      // kFoldSplit); output kq of a row at (k1, k2, k3) of its buffer.
      cluster_sync_all();
      const unsigned rank = cluster_ctarank(), csize = cluster_nctarank();
      const long long row0 = t - rank;
      const R split_scale = inverse ? kInvN * pow2_neg<R>(p_log2) : R(1);
      // Block `rank` stores k3 in [rank*K3, (rank+1)*K3), K3 = R3/C, of
      // every kA, k3 fastest: consecutive kq of its share then sit in
      // consecutive words of the other blocks' buffers.
      const int k3_log2 = ilog2(R3) - (__ffs(csize) - 1);
      split_fold_store<false>(
          [&](int j, int kq) {
            const int k3 = kq / Q, ka = kq - k3 * Q;
            const int k2 = ka / R1, k1 = ka - k2 * R1;
            return *cluster_map(s + k1 * PITCH + k2 * R3 + k3, j);
          },
          [&](int t) {
            return (t >> k3_log2) +
                   Q * (((int)rank << k3_log2) + (t & ((1 << k3_log2) - 1)));
          },
          N / csize, out, gtw, batch >> p_log2, row0 >> p_log2, 1 << p_log2,
          (int)(row0 & ((1 << p_log2) - 1)), __ffs(csize) - 1, csize, seg,
          inv_seg, split_scale, 0);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      cluster_sync_all();  // every block has read the rows it stores
    }
    // The buffer's generic-proxy reads and writes are ordered before the
    // bulk copies (async proxy) that overwrite it with the tile DEPTH
    // strides on.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (LANES == 1 ? tid == 0 : tid < LANES) {
      const long long next = t + DEPTH * stride;
      if (next < tiles)
        load_tile<R, R1, M1, PITCH, LANES>(s, x + next * LT * N,
                                           tile_lines(next), &bars[slot],
                                           tid);
    }
    if (++slot == DEPTH) {
      slot = 0;
      parity ^= 1;
    }
  }
}

// The mixed lengths' kernel: one line per block at a time, a ring of
// DEPTH line buffers (long_mixed_depth), the grid persistent.
template <typename R, int R1, int R2, int R3>
__global__ void __launch_bounds__(
    (long_mixed_threads<R, R1, R2, R3>()),
    (long_mixed_min_blocks<R, R1, R2, R3>()))
long_mixed_kernel(const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
                  const cpx<R>* __restrict__ consts,
                  const cpx<R>* __restrict__ gtw, long long batch,
                  int inverse, int seg) {
  static_assert(!is_pow2(R1), "R1 is mixed");
  mixed_tiles<R, R1, R2, R3, 1, long_mixed_threads<R, R1, R2, R3>(),
              long_mixed_depth<R, R1, R2, R3>(), 1>(x, out, consts, gtw,
                                                    batch, inverse, seg);
}
// The ring holds two line buffers where they fit in a block's 227 KB
// (complex64 8192, complex128 2048 and 4096), else one
// (kernels/longline.py::long_tile works out the same depth).
template <typename R, int R1, int R2, int R3>
constexpr int long_depth() {
  return long_smem_bytes<R, R1, R2, R3, 2>() <= kLongSmemMax ? 2 : 1;
}

// The lengths of build part PART (build_part, fft_radix.cuh) on the
// long-line kernels; cudaErrorInvalidValue for any other N.
template <typename R, int PART>
int long_part(int n, const void* x, void* out, const void* consts,
              const void* tw, long long batch, int inverse, int seg_arg,
              int smem_bytes, cudaStream_t stream);

#if !defined(REPRO_PART) || REPRO_PART >= 0
template <typename R, int PART>
int long_part(int n, const void* x, void* out, const void* consts,
              const void* tw, long long batch, int inverse, int seg_arg,
              int smem_bytes, cudaStream_t stream) {
  constexpr bool c64 = sizeof(R) == sizeof(float);
#define REPRO_LONG_CASE(NN, A, B, C)                                       \
  case NN:                                                                 \
    if constexpr (build_part(NN, kLongMode, c64) == PART)                  \
      return long_launch<R>(                                               \
          long_kernel<R, A, B, C, long_depth<R, A, B, C>()>,               \
          LongShape<A, B, C>::THREADS,                                     \
          long_smem_bytes<R, A, B, C, long_depth<R, A, B, C>()>(), x, out, \
          consts, tw, batch, inverse, seg_arg, smem_bytes, stream);        \
    break;
#define REPRO_LONG_MIXED_CASE(NN, A, B, C)                                 \
  case NN:                                                                 \
    if constexpr (build_part(NN, kLongMode, c64) == PART)                  \
      return long_launch<R>(                                               \
          long_mixed_kernel<R, A, B, C>, long_mixed_threads<R, A, B, C>(), \
          long_mixed_smem_bytes<R, A, B, C,                                \
                                long_mixed_depth<R, A, B, C>()>(),         \
          x, out, consts, tw, batch, inverse, seg_arg, smem_bytes, stream); \
    break;
  // kernels/longline.py::FACTORS lists the same factors.  seg_arg is the
  // pack_parts segment's log2 for a power of two, its length for a mixed N.
  if constexpr (c64) {
    switch (n) {
      REPRO_LONG_CASE(8192, 16, 16, 32)
      REPRO_LONG_CASE(16384, 16, 32, 32)
      REPRO_LONG_MIXED_CASE(4608, 18, 16, 16)
      REPRO_LONG_MIXED_CASE(5120, 20, 16, 16)
      REPRO_LONG_MIXED_CASE(6144, 24, 16, 16)
      REPRO_LONG_MIXED_CASE(7680, 30, 16, 16)
      REPRO_LONG_MIXED_CASE(9216, 18, 16, 32)
      REPRO_LONG_MIXED_CASE(10240, 20, 16, 32)
      REPRO_LONG_MIXED_CASE(12288, 24, 16, 32)
      REPRO_LONG_MIXED_CASE(15360, 30, 16, 32)
      REPRO_LONG_MIXED_CASE(5632, 22, 16, 16)
      REPRO_LONG_MIXED_CASE(7168, 28, 16, 16)
      REPRO_LONG_MIXED_CASE(11264, 22, 16, 32)
      REPRO_LONG_MIXED_CASE(14336, 28, 16, 32)
      REPRO_LONG_MIXED_CASE(6656, 26, 16, 16)
      REPRO_LONG_MIXED_CASE(13312, 26, 16, 32)
      // R1 odd: 17*2^k, 19*2^k, 21*2^k, 25*2^k, 27*2^k and 23*2^k
      REPRO_LONG_MIXED_CASE(4352, 17, 16, 16)
      REPRO_LONG_MIXED_CASE(8704, 17, 16, 32)
      REPRO_LONG_MIXED_CASE(4864, 19, 16, 16)
      REPRO_LONG_MIXED_CASE(9728, 19, 16, 32)
      REPRO_LONG_MIXED_CASE(5888, 23, 16, 16)
      REPRO_LONG_MIXED_CASE(11776, 23, 16, 32)
      REPRO_LONG_MIXED_CASE(5376, 21, 16, 16)
      REPRO_LONG_MIXED_CASE(10752, 21, 16, 32)
      REPRO_LONG_MIXED_CASE(6400, 25, 16, 16)
      REPRO_LONG_MIXED_CASE(12800, 25, 16, 32)
      REPRO_LONG_MIXED_CASE(6912, 27, 16, 16)
      REPRO_LONG_MIXED_CASE(13824, 27, 16, 32)
      // R2 mixed too: the rule's lengths (longline.rule_factors)
      REPRO_LONG_MIXED_CASE(3168, 22, 9, 16)
      REPRO_LONG_MIXED_CASE(3696, 21, 11, 16)
      REPRO_LONG_MIXED_CASE(3744, 26, 9, 16)
      REPRO_LONG_MIXED_CASE(3872, 22, 11, 16)
      REPRO_LONG_MIXED_CASE(3888, 27, 9, 16)
      REPRO_LONG_MIXED_CASE(4000, 25, 10, 16)
      REPRO_LONG_MIXED_CASE(4160, 26, 10, 16)
      REPRO_LONG_MIXED_CASE(4200, 25, 21, 8)
      REPRO_LONG_MIXED_CASE(4224, 24, 11, 16)
      REPRO_LONG_MIXED_CASE(4320, 30, 9, 16)
      REPRO_LONG_MIXED_CASE(4368, 21, 13, 16)
      REPRO_LONG_MIXED_CASE(4400, 25, 11, 16)
      REPRO_LONG_MIXED_CASE(4480, 28, 10, 16)
      REPRO_LONG_MIXED_CASE(4536, 27, 21, 8)
      REPRO_LONG_MIXED_CASE(4576, 26, 11, 16)
      REPRO_LONG_MIXED_CASE(4704, 21, 14, 16)
      REPRO_LONG_MIXED_CASE(4752, 27, 11, 16)
      REPRO_LONG_MIXED_CASE(4800, 30, 10, 16)
      REPRO_LONG_MIXED_CASE(4928, 28, 11, 16)
      REPRO_LONG_MIXED_CASE(4992, 26, 12, 16)
      REPRO_LONG_MIXED_CASE(5000, 25, 25, 8)
      REPRO_LONG_MIXED_CASE(5040, 21, 15, 16)
      REPRO_LONG_MIXED_CASE(5184, 27, 12, 16)
      REPRO_LONG_MIXED_CASE(5200, 25, 13, 16)
      REPRO_LONG_MIXED_CASE(5280, 30, 11, 16)
      REPRO_LONG_MIXED_CASE(5400, 27, 25, 8)
      REPRO_LONG_MIXED_CASE(5408, 26, 13, 16)
      REPRO_LONG_MIXED_CASE(5600, 25, 14, 16)
      REPRO_LONG_MIXED_CASE(5616, 27, 13, 16)
      REPRO_LONG_MIXED_CASE(5760, 30, 12, 16)
      REPRO_LONG_MIXED_CASE(5824, 28, 13, 16)
      REPRO_LONG_MIXED_CASE(5832, 27, 27, 8)
      REPRO_LONG_MIXED_CASE(6000, 25, 15, 16)
      REPRO_LONG_MIXED_CASE(6048, 27, 14, 16)
      REPRO_LONG_MIXED_CASE(6240, 30, 13, 16)
      REPRO_LONG_MIXED_CASE(6272, 28, 14, 16)
      REPRO_LONG_MIXED_CASE(6336, 22, 18, 16)
      REPRO_LONG_MIXED_CASE(6480, 27, 15, 16)
      REPRO_LONG_MIXED_CASE(6720, 30, 7, 32)
      REPRO_LONG_MIXED_CASE(7040, 22, 10, 32)
      REPRO_LONG_MIXED_CASE(7056, 21, 21, 16)
      REPRO_LONG_MIXED_CASE(7200, 25, 9, 32)
      REPRO_LONG_MIXED_CASE(7392, 21, 11, 32)
      REPRO_LONG_MIXED_CASE(7488, 26, 9, 32)
      REPRO_LONG_MIXED_CASE(7744, 22, 11, 32)
      REPRO_LONG_MIXED_CASE(7776, 27, 9, 32)
      REPRO_LONG_MIXED_CASE(8000, 25, 10, 32)
      REPRO_LONG_MIXED_CASE(8064, 28, 9, 32)
      REPRO_LONG_MIXED_CASE(8320, 26, 10, 32)
      REPRO_LONG_MIXED_CASE(8400, 25, 21, 16)
      REPRO_LONG_MIXED_CASE(8448, 24, 11, 32)
      REPRO_LONG_MIXED_CASE(8640, 30, 9, 32)
      REPRO_LONG_MIXED_CASE(8736, 21, 13, 32)
      REPRO_LONG_MIXED_CASE(8800, 25, 11, 32)
      REPRO_LONG_MIXED_CASE(8960, 28, 10, 32)
      REPRO_LONG_MIXED_CASE(9072, 27, 21, 16)
      REPRO_LONG_MIXED_CASE(9152, 26, 11, 32)
      REPRO_LONG_MIXED_CASE(9408, 21, 14, 32)
      REPRO_LONG_MIXED_CASE(9504, 27, 11, 32)
      REPRO_LONG_MIXED_CASE(9600, 30, 10, 32)
      REPRO_LONG_MIXED_CASE(9856, 28, 11, 32)
      REPRO_LONG_MIXED_CASE(9984, 26, 12, 32)
      REPRO_LONG_MIXED_CASE(10000, 25, 25, 16)
      REPRO_LONG_MIXED_CASE(10080, 21, 15, 32)
      REPRO_LONG_MIXED_CASE(10368, 27, 12, 32)
      REPRO_LONG_MIXED_CASE(10400, 25, 13, 32)
      REPRO_LONG_MIXED_CASE(10560, 30, 11, 32)
      REPRO_LONG_MIXED_CASE(10800, 27, 25, 16)
      REPRO_LONG_MIXED_CASE(10816, 26, 13, 32)
      REPRO_LONG_MIXED_CASE(11200, 25, 14, 32)
      REPRO_LONG_MIXED_CASE(11232, 27, 13, 32)
      REPRO_LONG_MIXED_CASE(11520, 30, 12, 32)
      REPRO_LONG_MIXED_CASE(11648, 28, 13, 32)
      REPRO_LONG_MIXED_CASE(11664, 27, 27, 16)
      REPRO_LONG_MIXED_CASE(12000, 25, 15, 32)
      REPRO_LONG_MIXED_CASE(12096, 27, 14, 32)
      REPRO_LONG_MIXED_CASE(12480, 30, 13, 32)
      REPRO_LONG_MIXED_CASE(12544, 28, 14, 32)
      REPRO_LONG_MIXED_CASE(12672, 22, 18, 32)
      REPRO_LONG_MIXED_CASE(12960, 27, 15, 32)
      REPRO_LONG_MIXED_CASE(13440, 30, 14, 32)
      REPRO_LONG_MIXED_CASE(14080, 22, 20, 32)
      REPRO_LONG_MIXED_CASE(14112, 21, 21, 32)
      REPRO_LONG_MIXED_CASE(14400, 30, 15, 32)
      REPRO_LONG_MIXED_CASE(14784, 22, 21, 32)
      REPRO_LONG_MIXED_CASE(14976, 26, 18, 32)
      REPRO_LONG_MIXED_CASE(15488, 22, 22, 32)
      REPRO_LONG_MIXED_CASE(15552, 27, 18, 32)
      REPRO_LONG_MIXED_CASE(16000, 25, 20, 32)
      REPRO_LONG_MIXED_CASE(16128, 28, 18, 32)
      default:
        break;
    }
  } else {
    switch (n) {
      REPRO_LONG_CASE(2048, 8, 16, 16)
      REPRO_LONG_CASE(4096, 16, 16, 16)
      REPRO_LONG_CASE(8192, 16, 16, 32)
      REPRO_LONG_MIXED_CASE(1152, 18, 8, 8)
      REPRO_LONG_MIXED_CASE(1280, 20, 8, 8)
      REPRO_LONG_MIXED_CASE(1536, 24, 8, 8)
      REPRO_LONG_MIXED_CASE(1920, 30, 8, 8)
      REPRO_LONG_MIXED_CASE(2304, 18, 8, 16)
      REPRO_LONG_MIXED_CASE(2560, 20, 8, 16)
      REPRO_LONG_MIXED_CASE(3072, 24, 8, 16)
      REPRO_LONG_MIXED_CASE(3840, 30, 8, 16)
      REPRO_LONG_MIXED_CASE(4608, 18, 16, 16)
      REPRO_LONG_MIXED_CASE(5120, 20, 16, 16)
      REPRO_LONG_MIXED_CASE(6144, 24, 16, 16)
      REPRO_LONG_MIXED_CASE(7680, 30, 16, 16)
      REPRO_LONG_MIXED_CASE(1408, 22, 8, 8)
      REPRO_LONG_MIXED_CASE(1792, 28, 8, 8)
      REPRO_LONG_MIXED_CASE(2816, 22, 8, 16)
      REPRO_LONG_MIXED_CASE(3584, 28, 8, 16)
      REPRO_LONG_MIXED_CASE(5632, 22, 16, 16)
      REPRO_LONG_MIXED_CASE(7168, 28, 16, 16)
      REPRO_LONG_MIXED_CASE(1664, 26, 8, 8)
      REPRO_LONG_MIXED_CASE(3328, 26, 8, 16)
      REPRO_LONG_MIXED_CASE(6656, 26, 16, 16)
      REPRO_LONG_MIXED_CASE(1344, 21, 8, 8)
      REPRO_LONG_MIXED_CASE(2688, 21, 8, 16)
      REPRO_LONG_MIXED_CASE(5376, 21, 16, 16)
      REPRO_LONG_MIXED_CASE(1600, 25, 8, 8)
      REPRO_LONG_MIXED_CASE(3200, 25, 8, 16)
      REPRO_LONG_MIXED_CASE(6400, 25, 16, 16)
      REPRO_LONG_MIXED_CASE(1728, 27, 8, 8)
      REPRO_LONG_MIXED_CASE(3456, 27, 8, 16)
      REPRO_LONG_MIXED_CASE(6912, 27, 16, 16)
      // 17*2^k, 19*2^k and 23*2^k (R1 odd)
      REPRO_LONG_MIXED_CASE(1088, 17, 8, 8)
      REPRO_LONG_MIXED_CASE(2176, 17, 8, 16)
      REPRO_LONG_MIXED_CASE(4352, 17, 16, 16)
      REPRO_LONG_MIXED_CASE(1216, 19, 8, 8)
      REPRO_LONG_MIXED_CASE(2432, 19, 8, 16)
      REPRO_LONG_MIXED_CASE(4864, 19, 16, 16)
      REPRO_LONG_MIXED_CASE(1472, 23, 8, 8)
      REPRO_LONG_MIXED_CASE(2944, 23, 8, 16)
      REPRO_LONG_MIXED_CASE(5888, 23, 16, 16)
      // R2 mixed too: the rule's lengths (longline.rule_factors)
      REPRO_LONG_MIXED_CASE(792, 11, 9, 8)
      REPRO_LONG_MIXED_CASE(880, 11, 5, 16)
      REPRO_LONG_MIXED_CASE(882, 21, 21, 2)
      REPRO_LONG_MIXED_CASE(924, 21, 11, 4)
      REPRO_LONG_MIXED_CASE(936, 13, 9, 8)
      REPRO_LONG_MIXED_CASE(968, 11, 11, 8)
      REPRO_LONG_MIXED_CASE(972, 27, 9, 4)
      REPRO_LONG_MIXED_CASE(1000, 25, 5, 8)
      REPRO_LONG_MIXED_CASE(1008, 21, 3, 16)
      REPRO_LONG_MIXED_CASE(1040, 13, 5, 16)
      REPRO_LONG_MIXED_CASE(1050, 25, 21, 2)
      REPRO_LONG_MIXED_CASE(1056, 22, 3, 16)
      REPRO_LONG_MIXED_CASE(1080, 27, 5, 8)
      REPRO_LONG_MIXED_CASE(1092, 21, 13, 4)
      REPRO_LONG_MIXED_CASE(1100, 25, 11, 4)
      REPRO_LONG_MIXED_CASE(1120, 14, 5, 16)
      REPRO_LONG_MIXED_CASE(1134, 27, 21, 2)
      REPRO_LONG_MIXED_CASE(1144, 13, 11, 8)
      REPRO_LONG_MIXED_CASE(1176, 21, 7, 8)
      REPRO_LONG_MIXED_CASE(1188, 27, 11, 4)
      REPRO_LONG_MIXED_CASE(1200, 25, 3, 16)
      REPRO_LONG_MIXED_CASE(1232, 11, 7, 16)
      REPRO_LONG_MIXED_CASE(1248, 26, 3, 16)
      REPRO_LONG_MIXED_CASE(1250, 25, 25, 2)
      REPRO_LONG_MIXED_CASE(1260, 21, 15, 4)
      REPRO_LONG_MIXED_CASE(1296, 27, 3, 16)
      REPRO_LONG_MIXED_CASE(1300, 25, 13, 4)
      REPRO_LONG_MIXED_CASE(1320, 15, 11, 8)
      REPRO_LONG_MIXED_CASE(1350, 27, 25, 2)
      REPRO_LONG_MIXED_CASE(1352, 13, 13, 8)
      REPRO_LONG_MIXED_CASE(1400, 25, 7, 8)
      REPRO_LONG_MIXED_CASE(1404, 27, 13, 4)
      REPRO_LONG_MIXED_CASE(1440, 30, 3, 16)
      REPRO_LONG_MIXED_CASE(1456, 13, 7, 16)
      REPRO_LONG_MIXED_CASE(1458, 27, 27, 2)
      REPRO_LONG_MIXED_CASE(1500, 25, 15, 4)
      REPRO_LONG_MIXED_CASE(1512, 27, 7, 8)
      REPRO_LONG_MIXED_CASE(1560, 15, 13, 8)
      REPRO_LONG_MIXED_CASE(1568, 14, 7, 16)
      REPRO_LONG_MIXED_CASE(1584, 11, 9, 16)
      REPRO_LONG_MIXED_CASE(1620, 27, 15, 4)
      REPRO_LONG_MIXED_CASE(1680, 21, 5, 16)
      REPRO_LONG_MIXED_CASE(1760, 22, 5, 16)
      REPRO_LONG_MIXED_CASE(1764, 21, 21, 4)
      REPRO_LONG_MIXED_CASE(1800, 25, 9, 8)
      REPRO_LONG_MIXED_CASE(1848, 21, 11, 8)
      REPRO_LONG_MIXED_CASE(1872, 13, 9, 16)
      REPRO_LONG_MIXED_CASE(1936, 11, 11, 16)
      REPRO_LONG_MIXED_CASE(1944, 27, 9, 8)
      REPRO_LONG_MIXED_CASE(2000, 25, 5, 16)
      REPRO_LONG_MIXED_CASE(2016, 21, 6, 16)
      REPRO_LONG_MIXED_CASE(2080, 26, 5, 16)
      REPRO_LONG_MIXED_CASE(2100, 25, 21, 4)
      REPRO_LONG_MIXED_CASE(2112, 22, 6, 16)
      REPRO_LONG_MIXED_CASE(2160, 27, 5, 16)
      REPRO_LONG_MIXED_CASE(2184, 21, 13, 8)
      REPRO_LONG_MIXED_CASE(2200, 25, 11, 8)
      REPRO_LONG_MIXED_CASE(2240, 28, 5, 16)
      REPRO_LONG_MIXED_CASE(2268, 27, 21, 4)
      REPRO_LONG_MIXED_CASE(2288, 13, 11, 16)
      REPRO_LONG_MIXED_CASE(2352, 21, 7, 16)
      REPRO_LONG_MIXED_CASE(2376, 27, 11, 8)
      REPRO_LONG_MIXED_CASE(2400, 30, 5, 16)
      REPRO_LONG_MIXED_CASE(2464, 22, 7, 16)
      REPRO_LONG_MIXED_CASE(2496, 26, 6, 16)
      REPRO_LONG_MIXED_CASE(2500, 25, 25, 4)
      REPRO_LONG_MIXED_CASE(2520, 21, 15, 8)
      REPRO_LONG_MIXED_CASE(2592, 27, 6, 16)
      REPRO_LONG_MIXED_CASE(2600, 25, 13, 8)
      REPRO_LONG_MIXED_CASE(2640, 15, 11, 16)
      REPRO_LONG_MIXED_CASE(2700, 27, 25, 4)
      REPRO_LONG_MIXED_CASE(2704, 13, 13, 16)
      REPRO_LONG_MIXED_CASE(2800, 25, 7, 16)
      REPRO_LONG_MIXED_CASE(2808, 27, 13, 8)
      REPRO_LONG_MIXED_CASE(2880, 30, 6, 16)
      REPRO_LONG_MIXED_CASE(2912, 26, 7, 16)
      REPRO_LONG_MIXED_CASE(2916, 27, 27, 4)
      REPRO_LONG_MIXED_CASE(3000, 25, 15, 8)
      REPRO_LONG_MIXED_CASE(3024, 27, 7, 16)
      REPRO_LONG_MIXED_CASE(3120, 15, 13, 16)
      REPRO_LONG_MIXED_CASE(3136, 28, 7, 16)
      REPRO_LONG_MIXED_CASE(3168, 22, 9, 16)
      REPRO_LONG_MIXED_CASE(3240, 27, 15, 8)
      REPRO_LONG_MIXED_CASE(3360, 30, 7, 16)
      REPRO_LONG_MIXED_CASE(3520, 22, 10, 16)
      REPRO_LONG_MIXED_CASE(3528, 21, 21, 8)
      REPRO_LONG_MIXED_CASE(3600, 25, 9, 16)
      REPRO_LONG_MIXED_CASE(3696, 21, 11, 16)
      REPRO_LONG_MIXED_CASE(3744, 26, 9, 16)
      REPRO_LONG_MIXED_CASE(3872, 22, 11, 16)
      REPRO_LONG_MIXED_CASE(3888, 27, 9, 16)
      REPRO_LONG_MIXED_CASE(4000, 25, 10, 16)
      REPRO_LONG_MIXED_CASE(4032, 28, 9, 16)
      REPRO_LONG_MIXED_CASE(4160, 26, 10, 16)
      REPRO_LONG_MIXED_CASE(4200, 25, 21, 8)
      REPRO_LONG_MIXED_CASE(4224, 24, 11, 16)
      REPRO_LONG_MIXED_CASE(4320, 30, 9, 16)
      REPRO_LONG_MIXED_CASE(4368, 21, 13, 16)
      REPRO_LONG_MIXED_CASE(4400, 25, 11, 16)
      REPRO_LONG_MIXED_CASE(4480, 28, 10, 16)
      REPRO_LONG_MIXED_CASE(4536, 27, 21, 8)
      REPRO_LONG_MIXED_CASE(4576, 26, 11, 16)
      REPRO_LONG_MIXED_CASE(4704, 21, 14, 16)
      REPRO_LONG_MIXED_CASE(4752, 27, 11, 16)
      REPRO_LONG_MIXED_CASE(4800, 30, 10, 16)
      REPRO_LONG_MIXED_CASE(4928, 28, 11, 16)
      REPRO_LONG_MIXED_CASE(4992, 26, 12, 16)
      REPRO_LONG_MIXED_CASE(5000, 25, 25, 8)
      REPRO_LONG_MIXED_CASE(5040, 21, 15, 16)
      REPRO_LONG_MIXED_CASE(5184, 27, 12, 16)
      REPRO_LONG_MIXED_CASE(5200, 25, 13, 16)
      REPRO_LONG_MIXED_CASE(5280, 30, 11, 16)
      REPRO_LONG_MIXED_CASE(5400, 27, 25, 8)
      REPRO_LONG_MIXED_CASE(5408, 26, 13, 16)
      REPRO_LONG_MIXED_CASE(5600, 25, 14, 16)
      REPRO_LONG_MIXED_CASE(5616, 27, 13, 16)
      REPRO_LONG_MIXED_CASE(5760, 30, 12, 16)
      REPRO_LONG_MIXED_CASE(5824, 28, 13, 16)
      REPRO_LONG_MIXED_CASE(5832, 27, 27, 8)
      REPRO_LONG_MIXED_CASE(6000, 25, 15, 16)
      REPRO_LONG_MIXED_CASE(6048, 27, 14, 16)
      REPRO_LONG_MIXED_CASE(6240, 30, 13, 16)
      REPRO_LONG_MIXED_CASE(6272, 28, 14, 16)
      REPRO_LONG_MIXED_CASE(6336, 22, 18, 16)
      REPRO_LONG_MIXED_CASE(6480, 27, 15, 16)
      REPRO_LONG_MIXED_CASE(6720, 30, 14, 16)
      REPRO_LONG_MIXED_CASE(7040, 22, 20, 16)
      REPRO_LONG_MIXED_CASE(7056, 21, 21, 16)
      REPRO_LONG_MIXED_CASE(7200, 30, 15, 16)
      REPRO_LONG_MIXED_CASE(7392, 22, 21, 16)
      REPRO_LONG_MIXED_CASE(7488, 26, 18, 16)
      REPRO_LONG_MIXED_CASE(7744, 22, 22, 16)
      REPRO_LONG_MIXED_CASE(7776, 27, 18, 16)
      REPRO_LONG_MIXED_CASE(8000, 25, 20, 16)
      REPRO_LONG_MIXED_CASE(8064, 28, 18, 16)
      default:
        break;
    }
  }
#undef REPRO_LONG_CASE
#undef REPRO_LONG_MIXED_CASE
  return (int)cudaErrorInvalidValue;
}
#endif

// The chirp route's transforms on the power-of-two lengths of this route
// (kernels/longline.py::FOLD_SIZES), fold = kFoldIn or kFoldOut, in build
// part build_part(n, kLongChirpMode, c64); cudaErrorInvalidValue for any
// other N or fold.
constexpr int kLongChirpMode = 4;

template <typename R, int PART>
int long_chirp_part(int n, int fold, const void* x, void* out,
                    const void* consts, const void* tw, const void* pre,
                    long long batch, int inverse, int seg_log2, int n_in,
                    int n_out, int fold_seg, int smem_bytes,
                    cudaStream_t stream);

#if !defined(REPRO_PART) || REPRO_PART >= 0
template <typename R, typename Kernel>
int long_chirp_launch(Kernel kernel, int threads, size_t layout_bytes,
                      const void* x, void* out, const void* consts,
                      const void* tw, const void* pre, long long batch,
                      int inverse, int seg_log2, int n_in, int n_out,
                      int fold_seg, int smem_bytes, cudaStream_t stream) {
  if ((size_t)smem_bytes != layout_bytes) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > batch) grid = batch;
  kernel<<<(unsigned)grid, threads, (size_t)smem_bytes, stream>>>(
      static_cast<const cpx<R>*>(x), static_cast<cpx<R>*>(out),
      static_cast<const cpx<R>*>(consts), static_cast<const cpx<R>*>(tw),
      static_cast<const cpx<R>*>(pre), batch, inverse, seg_log2, n_in, n_out,
      fold_seg);
  return (int)cudaGetLastError();
}

template <typename R, int PART>
int long_chirp_part(int n, int fold, const void* x, void* out,
                    const void* consts, const void* tw, const void* pre,
                    long long batch, int inverse, int seg_log2, int n_in,
                    int n_out, int fold_seg, int smem_bytes,
                    cudaStream_t stream) {
  constexpr bool c64 = sizeof(R) == sizeof(float);
#define REPRO_LONG_CHIRP_CASE(NN, A, B, C)                                 \
  case NN:                                                                 \
    if constexpr (build_part(NN, kLongChirpMode, c64) == PART) {           \
      constexpr int D = long_depth<R, A, B, C>();                          \
      if (fold == kFoldIn)                                                 \
        return long_chirp_launch<R>(                                       \
            long_chirp_kernel<R, A, B, C, D, kFoldIn>,                     \
            LongShape<A, B, C>::THREADS, long_smem_bytes<R, A, B, C, D>(), \
            x, out, consts, tw, pre, batch, inverse, seg_log2, n_in, n_out,\
            fold_seg, smem_bytes, stream);                                 \
      if (fold == kFoldOut)                                                \
        return long_chirp_launch<R>(                                       \
            long_chirp_kernel<R, A, B, C, D, kFoldOut>,                    \
            LongShape<A, B, C>::THREADS, long_smem_bytes<R, A, B, C, D>(), \
            x, out, consts, tw, pre, batch, inverse, seg_log2, n_in, n_out,\
            fold_seg, smem_bytes, stream);                                 \
    }                                                                      \
    break;
  // kernels/longline.py::FOLD_SIZES lists the same lengths.
  if constexpr (c64) {
    switch (n) {
      REPRO_LONG_CHIRP_CASE(8192, 16, 16, 32)
      REPRO_LONG_CHIRP_CASE(16384, 16, 32, 32)
    }
  } else {
    switch (n) {
      REPRO_LONG_CHIRP_CASE(2048, 8, 16, 16)
      REPRO_LONG_CHIRP_CASE(4096, 16, 16, 16)
      REPRO_LONG_CHIRP_CASE(8192, 16, 16, 32)
    }
  }
#undef REPRO_LONG_CHIRP_CASE
  return (int)cudaErrorInvalidValue;
}
#endif

// Lines of n on the chirp route's long-line kernels: long_chirp_part of
// n's build part.
template <typename R, int P = 0>
int long_chirp_dispatch(int n, int fold, const void* x, void* out,
                        const void* consts, const void* tw, const void* pre,
                        long long batch, int inverse, int seg_log2, int n_in,
                        int n_out, int fold_seg, int smem_bytes,
                        cudaStream_t stream) {
  if constexpr (P + 1 < kBuildParts) {
    if (build_part(n, kLongChirpMode, sizeof(R) == sizeof(float)) != P)
      return long_chirp_dispatch<R, P + 1>(
          n, fold, x, out, consts, tw, pre, batch, inverse, seg_log2, n_in,
          n_out, fold_seg, smem_bytes, stream);
  }
  return long_chirp_part<R, P>(n, fold, x, out, consts, tw, pre, batch,
                               inverse, seg_log2, n_in, n_out, fold_seg,
                               smem_bytes, stream);
}

// Lines of n on the long-line kernels: long_part of n's build part.
template <typename R, int P = 0>
int long_dispatch(int n, const void* x, void* out, const void* consts,
                  const void* tw, long long batch, int inverse, int seg_arg,
                  int smem_bytes, cudaStream_t stream) {
  if constexpr (P + 1 < kBuildParts) {
    if (build_part(n, kLongMode, sizeof(R) == sizeof(float)) != P)
      return long_dispatch<R, P + 1>(n, x, out, consts, tw, batch, inverse,
                                     seg_arg, smem_bytes, stream);
  }
  return long_part<R, P>(n, x, out, consts, tw, batch, inverse, seg_arg,
                         smem_bytes, stream);
}

// The split route's pass B on long rows with pass C folded in (kernels/
// split.py::fold_layout; fold_emulate is its plain version): `x` holds
// rows = B*P rows of Q = R1*R2*R3 (pass A's (B, P, Q) blocks, P = 2^p_log2),
// `out` (parts, B, P*Q/parts) with seg = P*Q/parts, `gtw` the line's
// output twiddle (P*Q values) or null; `inverse` scales by 1/(P*Q).  A
// cluster of C blocks (C divides P) runs C consecutive rows, one a block,
// on long_kernel's body (a power-of-two Q) or long_mixed_kernel's (a mixed
// Q), each kept in its block's shared memory, then stores them transposed
// in runs of C outputs (split_fold_store).  What bounds it: HBM, one read
// and one write of the rows (pass C read and wrote them once more); the
// cluster's distributed shared memory carries the transposition.
template <typename R, int R1, int R2, int R3, int DEPTH>
__global__ void __launch_bounds__(
    LongShape<R1, R2, R3>::THREADS,
    (long_min_blocks<R, R1, R2, R3, DEPTH>()))
split_fold_long_kernel(const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
                       const cpx<R>* __restrict__ consts,
                       const cpx<R>* __restrict__ gtw, long long rows,
                       int inverse, int p_log2, int seg) {
  long_body<R, R1, R2, R3, DEPTH, kFoldSplit>(
      x, out, consts, gtw, rows, inverse, 0,
      static_cast<const cpx<R>*>(nullptr), 0, 0, seg, p_log2);
}

template <typename R, int R1, int R2, int R3>
__global__ void __launch_bounds__(
    (long_mixed_threads<R, R1, R2, R3>()),
    (long_mixed_min_blocks<R, R1, R2, R3>()))
split_fold_mixed_kernel(const cpx<R>* __restrict__ x,
                        cpx<R>* __restrict__ out,
                        const cpx<R>* __restrict__ consts,
                        const cpx<R>* __restrict__ gtw, long long rows,
                        int inverse, int p_log2, int seg) {
  static_assert(!is_pow2(R1), "R1 is mixed");
  mixed_tiles<R, R1, R2, R3, 1, long_mixed_threads<R, R1, R2, R3>(),
              long_mixed_depth<R, R1, R2, R3>(), 1, true>(
      x, out, consts, gtw, rows, inverse, seg, p_log2);
}

// Launches `kernel` with clusters of `cluster` blocks (a power of two up
// to 8, the portable size) of `threads` threads and `smem_bytes` of
// dynamic shared memory, on a persistent grid: as many clusters as the
// card holds at once (cudaOccupancyMaxActiveClusters), at most `groups`.
// A cluster the card cannot hold is an error, not a smaller launch.
template <typename... Params, typename... Args>
int cluster_launch(void (*kernel)(Params...), int threads, int smem_bytes,
                   int cluster, long long groups, cudaStream_t stream,
                   Args... args) {
  if (cluster < 1 || cluster > 8 || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  if (groups <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  if (clusters > groups) clusters = (int)groups;
  cfg.gridDim = dim3((unsigned)(clusters * cluster), 1, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The split route's long rows with the folded store, in build part
// build_part(q, kSplitFoldMode, c64); cudaErrorInvalidValue for any other
// Q.  `smem_bytes` must equal the long kernel's layout of Q.
constexpr int kSplitFoldMode = 6;

template <typename R, int PART>
int split_fold_part(int q, const void* x, void* out, const void* consts,
                    const void* tw, long long rows, int inverse, int p_log2,
                    int seg, int cluster, int smem_bytes,
                    cudaStream_t stream);

#if !defined(REPRO_PART) || REPRO_PART >= 0
template <typename R, int PART>
int split_fold_part(int q, const void* x, void* out, const void* consts,
                    const void* tw, long long rows, int inverse, int p_log2,
                    int seg, int cluster, int smem_bytes,
                    cudaStream_t stream) {
  constexpr bool c64 = sizeof(R) == sizeof(float);
  if (p_log2 < 0 || p_log2 > 20 || cluster > (1 << p_log2) ||
      rows % cluster)
    return (int)cudaErrorInvalidValue;
#define REPRO_SPLIT_FOLD_ARGS                                              \
  static_cast<const cpx<R>*>(x), static_cast<cpx<R>*>(out),               \
      static_cast<const cpx<R>*>(consts), static_cast<const cpx<R>*>(tw),  \
      rows, inverse, p_log2, seg
#define REPRO_SPLIT_FOLD_CASE(NN, A, B, C)                                 \
  case NN:                                                                 \
    if constexpr (build_part(NN, kSplitFoldMode, c64) == PART) {           \
      constexpr int D = long_depth<R, A, B, C>();                          \
      if ((size_t)smem_bytes != long_smem_bytes<R, A, B, C, D>())          \
        return (int)cudaErrorInvalidValue;                                 \
      return cluster_launch(split_fold_long_kernel<R, A, B, C, D>,         \
                            LongShape<A, B, C>::THREADS, smem_bytes,       \
                            cluster, rows / cluster, stream,               \
                            REPRO_SPLIT_FOLD_ARGS);                        \
    }                                                                      \
    break;
#define REPRO_SPLIT_FOLD_MIXED_CASE(NN, A, B, C)                           \
  case NN:                                                                 \
    if constexpr (build_part(NN, kSplitFoldMode, c64) == PART) {           \
      if ((size_t)smem_bytes !=                                            \
          long_mixed_smem_bytes<R, A, B, C,                                \
                                long_mixed_depth<R, A, B, C>()>())         \
        return (int)cudaErrorInvalidValue;                                 \
      return cluster_launch(split_fold_mixed_kernel<R, A, B, C>,           \
                            long_mixed_threads<R, A, B, C>(), smem_bytes,  \
                            cluster, rows / cluster, stream,               \
                            REPRO_SPLIT_FOLD_ARGS);                        \
    }                                                                      \
    break;
  // kernels/split.py::FOLD_LONG_ROWS lists the same Q, longline.FACTORS
  // their factors.
  if constexpr (c64) {
    switch (q) {
      REPRO_SPLIT_FOLD_MIXED_CASE(3872, 22, 11, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4000, 25, 10, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4160, 26, 10, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4224, 24, 11, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4320, 30, 9, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4352, 17, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4480, 28, 10, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4576, 26, 11, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4608, 18, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4704, 21, 14, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4800, 30, 10, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4864, 19, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4928, 28, 11, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4992, 26, 12, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5120, 20, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5184, 27, 12, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5280, 30, 11, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5376, 21, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5408, 26, 13, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5600, 25, 14, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5632, 22, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5760, 30, 12, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5824, 28, 13, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5888, 23, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6048, 27, 14, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6144, 24, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6240, 30, 13, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6272, 28, 14, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6336, 22, 18, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6400, 25, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6656, 26, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6720, 30, 7, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(6912, 27, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(7040, 22, 10, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(7168, 28, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(7200, 25, 9, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(7392, 21, 11, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(7488, 26, 9, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(7680, 30, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(7744, 22, 11, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(7776, 27, 9, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(8000, 25, 10, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(8064, 28, 9, 32)
      REPRO_SPLIT_FOLD_CASE(8192, 16, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(8320, 26, 10, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(8448, 24, 11, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(8640, 30, 9, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(8704, 17, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(8736, 21, 13, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(8800, 25, 11, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(8960, 28, 10, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(9152, 26, 11, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(9216, 18, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(9408, 21, 14, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(9504, 27, 11, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(9600, 30, 10, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(9728, 19, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(9856, 28, 11, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(9984, 26, 12, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(10080, 21, 15, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(10240, 20, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(10368, 27, 12, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(10400, 25, 13, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(10560, 30, 11, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(10752, 21, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(10816, 26, 13, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(11200, 25, 14, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(11232, 27, 13, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(11264, 22, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(11520, 30, 12, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(11648, 28, 13, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(11776, 23, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(12000, 25, 15, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(12096, 27, 14, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(12288, 24, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(12480, 30, 13, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(12544, 28, 14, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(12672, 22, 18, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(12800, 25, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(12960, 27, 15, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(13312, 26, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(13440, 30, 14, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(13824, 27, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(14080, 22, 20, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(14112, 21, 21, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(14336, 28, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(14400, 30, 15, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(14784, 22, 21, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(14976, 26, 18, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(15360, 30, 16, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(15488, 22, 22, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(15552, 27, 18, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(16000, 25, 20, 32)
      REPRO_SPLIT_FOLD_MIXED_CASE(16128, 28, 18, 32)
      REPRO_SPLIT_FOLD_CASE(16384, 16, 32, 32)
      default:
        break;
    }
  } else {
    switch (q) {
      REPRO_SPLIT_FOLD_MIXED_CASE(1920, 30, 8, 8)
      REPRO_SPLIT_FOLD_MIXED_CASE(2304, 18, 8, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(2688, 21, 8, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(3200, 25, 8, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(3456, 27, 8, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(3584, 28, 8, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(3840, 30, 8, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4160, 26, 10, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4224, 24, 11, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4320, 30, 9, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4352, 17, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4480, 28, 10, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4576, 26, 11, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4608, 18, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4704, 21, 14, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4800, 30, 10, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4864, 19, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4928, 28, 11, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(4992, 26, 12, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5120, 20, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5184, 27, 12, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5280, 30, 11, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5376, 21, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5408, 26, 13, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5600, 25, 14, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5632, 22, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5760, 30, 12, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5824, 28, 13, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(5888, 23, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6048, 27, 14, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6144, 24, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6240, 30, 13, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6272, 28, 14, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6336, 22, 18, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6400, 25, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6656, 26, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6720, 30, 14, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(6912, 27, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(7040, 22, 20, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(7168, 28, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(7200, 30, 15, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(7392, 22, 21, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(7488, 26, 18, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(7680, 30, 16, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(7744, 22, 22, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(7776, 27, 18, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(8000, 25, 20, 16)
      REPRO_SPLIT_FOLD_MIXED_CASE(8064, 28, 18, 16)
      REPRO_SPLIT_FOLD_CASE(8192, 16, 16, 32)
      default:
        break;
    }
  }
#undef REPRO_SPLIT_FOLD_ARGS
#undef REPRO_SPLIT_FOLD_CASE
#undef REPRO_SPLIT_FOLD_MIXED_CASE
  return (int)cudaErrorInvalidValue;
}
#endif

// Rows of q on the split route's folded long rows: split_fold_part of q's
// build part.
template <typename R, int P = 0>
int split_fold_dispatch(int q, const void* x, void* out, const void* consts,
                        const void* tw, long long rows, int inverse,
                        int p_log2, int seg, int cluster, int smem_bytes,
                        cudaStream_t stream) {
  if constexpr (P + 1 < kBuildParts) {
    if (build_part(q, kSplitFoldMode, sizeof(R) == sizeof(float)) != P)
      return split_fold_dispatch<R, P + 1>(q, x, out, consts, tw, rows,
                                           inverse, p_log2, seg, cluster,
                                           smem_bytes, stream);
  }
  return split_fold_part<R, P>(q, x, out, consts, tw, rows, inverse, p_log2,
                               seg, cluster, smem_bytes, stream);
}

constexpr int kTransposeTile = 32;
constexpr int kTransposeRows = 8;

// Pass C for any P and Q (the split route's plans whose rows run their own
// launch in natural order, kernels/split.py::fold_layout is None: a nested
// plan's or a chirp's M whose rows take the radix, long-line or split
// route, and dense rows too long for the folded kernel's slot and tile): z
// holds B lines of (P, Q) rows z[b, kp, kq]; out[b, kp + P*kq] = z[b, kp,
// kq] times the output twiddle tw[kp + P*kq] (P*Q values, or null), times
// `scale`, the inverse's 1/P worked out on the host (the rows' launch
// applied the 1/Q), stored as (parts, B, seg), seg = P*Q/parts of any
// length (div_small).  A block moves one 32 x 32 tile through shared
// memory (row pitch 33), bounds-checked on kp and kq: it reads 32
// consecutive kq of a row and writes 32 consecutive kp of the output.
// Grid: (ceil(Q/32), ceil(P/32), up to 65535 lines).
//
// With kKeep (the chirp route's second transform on a split plan of M =
// P*Q, kernels/chirp.py) only the outputs of < n_keep (= N) are stored,
// `out` (parts, lines, N/parts) with seg = N/parts and `gtw` N values;
// without it split_transpose_any_kernel keeps its SASS.
template <bool kKeep, typename R>
__device__ __forceinline__ void split_transpose_any_body(
    const cpx<R>* __restrict__ z, cpx<R>* __restrict__ out,
    const cpx<R>* __restrict__ gtw, long long lines, int p, int q, int seg,
    R scale, int n_keep) {
  constexpr int T = kTransposeTile;
  __shared__ cpx<R> tile[T][T + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int kq0 = blockIdx.x * T, kp0 = blockIdx.y * T;
  const long long n = (long long)q * p;
  const float inv_seg = __fdividef(1.0f, (float)seg);
  const bool load_q = kq0 + tx < q;   // this thread's kq of the loads
  const bool store_p = kp0 + tx < p;  // and its kp of the stores
  for (long long b = blockIdx.z; b < lines; b += gridDim.z) {
    const cpx<R>* zb = z + b * n;
    for (int j = ty; j < T; j += kTransposeRows)
      if (load_q && kp0 + j < p)
        tile[j][tx] = zb[(long long)(kp0 + j) * q + kq0 + tx];
    __syncthreads();
    for (int j = ty; j < T; j += kTransposeRows) {
      if (store_p && kq0 + j < q) {
        const int of = kp0 + tx + (kq0 + j) * p;
        if (kKeep && of >= n_keep) continue;
        cpx<R> y = tile[tx][j];
        if (gtw != nullptr) y = cmul(y, gtw[of]);
        y.re *= scale;
        y.im *= scale;
        const int part = div_small(of, seg, inv_seg);
        out[((long long)part * lines + b) * seg + (of - part * seg)] = y;
      }
    }
    __syncthreads();  // the next line's loads overwrite the tile
  }
}

template <typename R>
__global__ void __launch_bounds__(kTransposeTile * kTransposeRows)
split_transpose_any_kernel(const cpx<R>* __restrict__ z,
                           cpx<R>* __restrict__ out,
                           const cpx<R>* __restrict__ gtw, long long lines,
                           int p, int q, int seg, R scale) {
  split_transpose_any_body<false>(z, out, gtw, lines, p, q, seg, scale, 0);
}

template <typename R>
__global__ void __launch_bounds__(kTransposeTile * kTransposeRows)
split_transpose_keep_kernel(const cpx<R>* __restrict__ z,
                            cpx<R>* __restrict__ out,
                            const cpx<R>* __restrict__ gtw, long long lines,
                            int p, int q, int seg, R scale, int n_keep) {
  split_transpose_any_body<true>(z, out, gtw, lines, p, q, seg, scale,
                                 n_keep);
}

// Pass C of a general plan: seg = P*Q/parts of any length; with n_keep <
// P*Q (the chirp's second transform) only the outputs of < n_keep, seg =
// n_keep/parts.
template <typename R>
int split_transpose_any(const void* z, void* out, const void* tw,
                        long long lines, int p, int q, int seg, int inverse,
                        cudaStream_t stream, int n_keep = 0) {
  if (lines <= 0) return 0;
  if (p < 1 || q < 1 || seg < 1 || (p + 31) / 32 > 65535 || n_keep < 0 ||
      (long long)n_keep > (long long)p * q)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((q + 31) / 32), (unsigned)((p + 31) / 32),
                  (unsigned)(lines < 65535 ? lines : 65535));
  const dim3 block(kTransposeTile, kTransposeRows);
  // 1/P rounded once, as the plain version's scale
  const R scale = inverse ? (R)(1.0 / (double)p) : R(1);
  if (n_keep > 0) {
    split_transpose_keep_kernel<R><<<grid, block, 0, stream>>>(
        static_cast<const cpx<R>*>(z), static_cast<cpx<R>*>(out),
        static_cast<const cpx<R>*>(tw), lines, p, q, seg, scale, n_keep);
  } else {
    split_transpose_any_kernel<R><<<grid, block, 0, stream>>>(
        static_cast<const cpx<R>*>(z), static_cast<cpx<R>*>(out),
        static_cast<const cpx<R>*>(tw), lines, p, q, seg, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_fft
