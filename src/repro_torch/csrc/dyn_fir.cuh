// The per-sample arithmetic of the DPD Poly actor: the basis
// phi_k(x) = x * |x|^(2(k-1)) and the causal 10-tap complex FIR.
//
// Shared by kernel B1 (dyn_fir.cu, one Poly firing per launch) and kernel
// B2 (megakernel.cu, every firing of a network in one launch), so the two
// give the same bits.  Every operation is rounded on its own (the _rn
// intrinsics, so nvcc contracts nothing into FMAs) and in the order of the
// plain PyTorch version (kernels/dyn_fir/ref.py); the basis power follows
// PyTorch's pow.  On the card both kernels then agree with the plain
// version to the bit wherever powf does.
#pragma once

#include <cuda_runtime.h>

namespace dyn_fir {

constexpr int N_TAPS = 10;
constexpr int HALO = N_TAPS - 1;  // history samples a window needs

// mag2 ** e as the plain version computes it on the card: PyTorch's pow
// with a scalar exponent fills 1 for e = 0, copies for e = 1, multiplies
// out e = 2 and 3, and calls powf otherwise.
__device__ __forceinline__ float basis_scale(float mag2, int e) {
  switch (e) {
    case 0: return 1.f;
    case 1: return mag2;
    case 2: return __fmul_rn(mag2, mag2);
    case 3: return __fmul_rn(__fmul_rn(mag2, mag2), mag2);
    default: return powf(mag2, static_cast<float>(e));
  }
}

// phi_order(x) for one complex sample: x * |x|^(2(order-1)).
__device__ __forceinline__ void basis(float xr, float xi, int order,
                                      float* br, float* bi) {
  const float mag2 = __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi));
  const float scale = basis_scale(mag2, order - 1);
  *br = __fmul_rn(xr, scale);
  *bi = __fmul_rn(xi, scale);
}

// One output sample of the FIR over staged basis values:
// y = sum_t h[t] * b[j + HALO - t], taps in order t = 0..9, each complex
// product term rounded as the plain version's
// y_re = y_re + h_re[t] * x_re - h_im[t] * x_im and
// y_im = y_im + h_re[t] * x_im + h_im[t] * x_re.
__device__ __forceinline__ void fir_mac(const float* b_re, const float* b_im,
                                        const float* h_re, const float* h_im,
                                        int j, float* y_re, float* y_im) {
  float yr = 0.f, yi = 0.f;
#pragma unroll
  for (int t = 0; t < N_TAPS; ++t) {
    const float sr = b_re[j + HALO - t];
    const float si = b_im[j + HALO - t];
    yr = __fsub_rn(__fadd_rn(yr, __fmul_rn(h_re[t], sr)), __fmul_rn(h_im[t], si));
    yi = __fadd_rn(__fadd_rn(yi, __fmul_rn(h_re[t], si)), __fmul_rn(h_im[t], sr));
  }
  *y_re = yr;
  *y_im = yi;
}

}  // namespace dyn_fir
