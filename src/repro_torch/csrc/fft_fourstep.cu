// Batched 1-D FFT of complex lines by the four-step method, for Hopper.
//
// Two paths, chosen by the wrapper from N and the dtype alone
// (kernels/radix.py::kernel_path): power-of-two N takes the radix path
// (fft_radix.cuh: in-register codelets, contiguous or strided lines); any
// other N takes the general dense kernel below.
//
// Replaces the TPU kernel src/repro/kernels/fft_matmul.py::_fft_kernel (the
// pl.pallas_call in fft1d_planes), with its two fused epilogues: the
// elementwise output twiddle and the pack_parts store.
//
// The dense path, below.  What it computes, per line x of length
// N = N1*N2 (transforms.factorize):
//   step 1  F1[k1, m2] = sum_m1 x[m1*N2 + m2] * W1[k1, m1]
//   step 2  G[k1, m2]  = F1[k1, m2] * T[k1, m2]
//   step 3  F2[k1, k2] = sum_m2 G[k1, m2] * W2[k2, m2]
//   step 4  out[k1 + N1*k2] = F2[k1, k2] (* tw[k1 + N1*k2]) (/ N if inverse)
// W1, W2 and T are the DFT and twiddle matrices, built in float64 on the
// host and cast (kernels/fft_matmul.py::_device_constants).  The
// forward/inverse sign lives in them; the kernel only applies the 1/N scale.
//
// What bounds it on an H100: the function (a length-N DFT of each line)
// needs about 5*N*log2(N) flops per line, against 16 bytes of complex64
// moved per element, so HBM (3.35 TB/s) is its floor.  The dense four-step
// chosen here does 8*N*(N1+N2) flops per line instead, about 390 per
// element at N = 512 (48 flops per byte), which puts its own work above
// that floor on the fp32 CUDA cores (67 TFLOP/s).  TF32 tensor cores would
// keep only 10 mantissa bits and break the 5e-6 parity with torch.fft, so
// every product is an fp32 (or fp64) FMA on the CUDA cores.
//
// What the design does about it:
//  * Interleaved complex in and out: the kernel reads complex64/complex128
//    lines directly, so there is no split into real/imag planes and no
//    recombine pass around it (the Pallas path needs both for the MXU).
//  * Constants in shared memory: each block copies W1, T, the optional
//    output twiddle and, when it takes at most 48 KB, W2 into shared
//    memory once.  A larger W2 (prime N gives (1, N), so W2 is N x N) is
//    read from global memory, where L2 keeps it, instead of refusing N.
//  * One block per tile of `lines` lines, sized by the wrapper to fit the
//    227 KB of shared memory (two blocks per SM where they fit).  The tile
//    is staged in shared memory so that each input element is read from
//    HBM once, though step 1 reads it N1 times.
//  * G is stored with a row pitch of N2+1, so step 3's reads down a
//    column of G (consecutive threads, consecutive k1) spread over banks.
//  * pack_parts = p stores the output destination-major, (p, B, N/p):
//    the send buffer of the next all_to_all, contiguous per destination,
//    so the exchange ships it without a copy.  p = 1 is the plain layout.

#include <cuda_runtime.h>

#include "fft_common.cuh"
#include "fft_radix.cuh"

namespace {

using repro_fft::cpx;
using repro_fft::cfma;
using repro_fft::cmul;

constexpr int kThreads = 256;

// Shared memory, in this order: W1 (n1*n1), T (n1*n2), the output twiddle
// (n, optional), W2 (n2*n2, optional), the staged lines (lines*n) and G
// (lines*n1*(n2+1)).  The wrapper sizes it (kernels/fft_matmul.py::
// smem_bytes) and passes the byte count in.
template <typename R>
__global__ void __launch_bounds__(kThreads)
fourstep_kernel(const cpx<R>* __restrict__ x, cpx<R>* __restrict__ out,
                const cpx<R>* __restrict__ gw1, const cpx<R>* __restrict__ gw2,
                const cpx<R>* __restrict__ gt, const cpx<R>* __restrict__ gtw,
                long long batch, int n1, int n2, int inverse, int parts,
                int lines, int w2_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cpx<R>* s = reinterpret_cast<cpx<R>*>(smem_raw);
  const int n = n1 * n2;
  const int pitch = n2 + 1;

  cpx<R>* sw1 = s;
  s += n1 * n1;
  cpx<R>* st = s;
  s += n;
  cpx<R>* stw = nullptr;
  if (gtw != nullptr) {
    stw = s;
    s += n;
  }
  const cpx<R>* w2 = gw2;
  if (w2_smem) {
    cpx<R>* sw2 = s;
    s += n2 * n2;
    for (int i = threadIdx.x; i < n2 * n2; i += blockDim.x) sw2[i] = gw2[i];
    w2 = sw2;
  }
  cpx<R>* sx = s;
  s += (long long)lines * n;
  cpx<R>* sg = s;

  for (int i = threadIdx.x; i < n1 * n1; i += blockDim.x) sw1[i] = gw1[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) st[i] = gt[i];
  if (stw != nullptr)
    for (int i = threadIdx.x; i < n; i += blockDim.x) stw[i] = gtw[i];

  const long long line0 = (long long)blockIdx.x * lines;
  const long long left = batch - line0;
  const int nl = left < lines ? (int)left : lines;
  const int work = nl * n;

  // Stage the tile: consecutive threads read consecutive elements.
  const cpx<R>* xb = x + line0 * n;
  for (int i = threadIdx.x; i < work; i += blockDim.x) sx[i] = xb[i];
  __syncthreads();

  // Steps 1 and 2: one thread per (line, k1, m2).
  for (int e = threadIdx.x; e < work; e += blockDim.x) {
    const int l = e / n;
    const int r = e - l * n;
    const int k1 = r / n2;
    const int m2 = r - k1 * n2;
    const cpx<R>* xl = sx + l * n + m2;
    const cpx<R>* w1row = sw1 + k1 * n1;
    R are = R(0), aim = R(0);
    for (int m1 = 0; m1 < n1; ++m1) cfma(xl[m1 * n2], w1row[m1], are, aim);
    cpx<R> a;
    a.re = are;
    a.im = aim;
    sg[(l * n1 + k1) * pitch + m2] = cmul(a, st[k1 * n2 + m2]);
  }
  __syncthreads();

  // Steps 3 and 4 with the epilogues: one thread per (line, output index).
  const R scale = inverse ? R(1) / R(n) : R(1);
  const int seg = n / parts;
  for (int e = threadIdx.x; e < work; e += blockDim.x) {
    const int l = e / n;
    const int o = e - l * n;  // o = k1 + n1*k2
    const int k2 = o / n1;
    const int k1 = o - k2 * n1;
    const cpx<R>* grow = sg + (l * n1 + k1) * pitch;
    const cpx<R>* w2row = w2 + (long long)k2 * n2;
    R are = R(0), aim = R(0);
    for (int m2 = 0; m2 < n2; ++m2) cfma(grow[m2], w2row[m2], are, aim);
    cpx<R> v;
    v.re = are;
    v.im = aim;
    if (stw != nullptr) v = cmul(v, stw[o]);
    v.re *= scale;
    v.im *= scale;
    const int part = o / seg;
    const int j = o - part * seg;
    out[((long long)part * batch + line0 + l) * seg + j] = v;
  }
}

template <typename R>
int launch(const void* x, void* out, const void* w1, const void* w2,
           const void* t, const void* tw, long long batch, int n1, int n2,
           int inverse, int parts, int lines, int w2_smem, int smem_bytes,
           void* stream) {
  if (batch <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fourstep_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (batch + lines - 1) / lines;
  fourstep_kernel<R><<<(unsigned)blocks, kThreads, (size_t)smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const cpx<R>*>(x), static_cast<cpx<R>*>(out),
      static_cast<const cpx<R>*>(w1), static_cast<const cpx<R>*>(w2),
      static_cast<const cpx<R>*>(t), static_cast<const cpx<R>*>(tw), batch,
      n1, n2, inverse, parts, lines, w2_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success).  `tw` may be
// null (no output twiddle).  `out` holds (parts, batch, n1*n2/parts).
// `smem_bytes` is the dynamic shared memory of one block.
int repro_fft_fourstep_c64(const void* x, void* out, const void* w1,
                           const void* w2, const void* t, const void* tw,
                           long long batch, int n1, int n2, int inverse,
                           int parts, int lines, int w2_smem, int smem_bytes,
                           void* stream) {
  return launch<float>(x, out, w1, w2, t, tw, batch, n1, n2, inverse, parts,
                       lines, w2_smem, smem_bytes, stream);
}

int repro_fft_fourstep_c128(const void* x, void* out, const void* w1,
                            const void* w2, const void* t, const void* tw,
                            long long batch, int n1, int n2, int inverse,
                            int parts, int lines, int w2_smem, int smem_bytes,
                            void* stream) {
  return launch<double>(x, out, w1, w2, t, tw, batch, n1, n2, inverse, parts,
                        lines, w2_smem, smem_bytes, stream);
}

// The radix path (fft_radix.cuh) for power-of-two N.  `consts` holds T
// (N1 x N2) then the codelet table (N2/2); `tw` may be null.  Contiguous
// lines: outer = B, inner = 1, strided = 0, `out` (parts, B, N/parts) with
// seg_log2 = log2(N/parts).  Strided lines: `x` and `out` are contiguous
// (outer, N, inner), strided = 1, seg_log2 = log2(N).  Returns the CUDA
// error code of the launch (0 on success).
int repro_fft_radix_c64(const void* x, void* out, const void* consts,
                        const void* tw, long long outer, long long inner,
                        int n, int inverse, int seg_log2, int lines_log2,
                        int strided, int smem_bytes, void* stream) {
  return repro_fft::radix_dispatch<float>(
      n, x, out, consts, tw, outer, inner, inverse, seg_log2, lines_log2,
      strided, smem_bytes, static_cast<cudaStream_t>(stream));
}

int repro_fft_radix_c128(const void* x, void* out, const void* consts,
                         const void* tw, long long outer, long long inner,
                         int n, int inverse, int seg_log2, int lines_log2,
                         int strided, int smem_bytes, void* stream) {
  return repro_fft::radix_dispatch<double>(
      n, x, out, consts, tw, outer, inner, inverse, seg_log2, lines_log2,
      strided, smem_bytes, static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
