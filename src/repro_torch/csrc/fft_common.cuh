// Complex values and their products, shared by the dense and the radix
// paths of the four-step kernel (fft_fourstep.cu, fft_radix.cuh).
#pragma once

#include <cuda_runtime.h>

namespace repro_fft {

// Interleaved complex, laid out as torch.complex64 / complex128.
template <typename R>
struct alignas(2 * sizeof(R)) cpx {
  R re;
  R im;
};

template <typename R>
__device__ __forceinline__ void cfma(cpx<R> a, cpx<R> w, R& acc_re, R& acc_im) {
  acc_re = fma(a.re, w.re, acc_re);
  acc_re = fma(-a.im, w.im, acc_re);
  acc_im = fma(a.re, w.im, acc_im);
  acc_im = fma(a.im, w.re, acc_im);
}

template <typename R>
__device__ __forceinline__ cpx<R> cmul(cpx<R> a, cpx<R> b) {
  cpx<R> r;
  r.re = a.re * b.re - a.im * b.im;
  r.im = a.re * b.im + a.im * b.re;
  return r;
}

template <typename R>
__device__ __forceinline__ cpx<R> cadd(cpx<R> a, cpx<R> b) {
  cpx<R> r;
  r.re = a.re + b.re;
  r.im = a.im + b.im;
  return r;
}

template <typename R>
__device__ __forceinline__ cpx<R> csub(cpx<R> a, cpx<R> b) {
  cpx<R> r;
  r.re = a.re - b.re;
  r.im = a.im - b.im;
  return r;
}

}  // namespace repro_fft
