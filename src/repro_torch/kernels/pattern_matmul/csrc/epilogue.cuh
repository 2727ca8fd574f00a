// The activation of the pattern-matmul kernels' fused epilogue
// (pattern_matmul.cu, f32, and pattern_matmul_bf16.cu): the `act` of
// kernels/epilogue.py's `bias_act`, applied to the f32 accumulator after
// the bias add.
#pragma once

#include <cuda_runtime.h>

namespace pm {

// Activation codes: kernels/epilogue.py ACT_CODES.
__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1:  // relu
      return v < 0.f ? 0.f : v;
    case 2: {  // gelu, tanh form (jax.nn.gelu's default)
      const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
      const float kKappa = 0.044715f;
      float inner = kBeta * (v + kKappa * v * v * v);
      return 0.5f * v * (1.f + tanhf(inner));
    }
    case 3:  // silu
      return v * (1.f / (1.f + expf(-v)));
    default:
      return v;
  }
}

}  // namespace pm
