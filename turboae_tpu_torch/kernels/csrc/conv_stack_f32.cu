// Fused same-length Conv1d + ELU stack in f32 for Hopper (sm_90a).
//
// Replaces turboae_tpu/kernels/conv_stack.py::_fused_forward (Pallas body
// _stack_kernel). What it computes, per batch row b:
//   h_0 = x[b]                                  (L, Cin), f32
//   h_n = ELU(sum_k h_{n-1}[l + k - K/2] @ W_n[k] + bias_n)   zero padding
// in f32 throughout: f32 operands, f32 accumulation, bias and ELU
// (exp(min(v,0)) - 1, as the Pallas kernel), no bf16 rounding and no TF32.
// Only the last layer is written to device memory.
//
// Bound: at the conv-stack bench's shape (B=500, L=100, Cin=7, C=100, K=5,
// 5 layers) a call does 2*B*L*(K*Cin*C + 4*K*C*C) = 2.04e10 FLOP on 22 MB of
// input, output and weights. Exact f32 excludes the tensor cores (TF32 keeps
// ten mantissa bits), so the CUDA cores' f32 rate bounds it: 0.30 ms at the
// H100 SXM's 67 TFLOP/s, against 0.007 ms for the bytes at 3.35 TB/s.
//
// Design (first version: simple and right), the f32 twin of
// conv_stack_bf16.cu:
//   - one thread block per batch row; the row's activations live in two f32
//     ping-pong buffers of (L+K-1) x C in shared memory whose K-1 halo rows
//     are zeroed once, so every tap reads a plain row (83.2 KB at the bench
//     shape, two blocks per SM; dynamic shared memory, up to 227 KB);
//   - layer 0 reads x straight from device memory, masking the padding;
//   - each thread owns a 4 (time) x 4 (channel) register tile of f32 sums and
//     walks the K*Cin contraction, one 16-byte weight load per step; weights
//     (packed (K*Cin, Cp) with Cp = C rounded up to 4, zero-filled) are read
//     from device memory and stay in L1/L2 across the blocks;
//   - FFMA on the CUDA cores, so it is bound by instruction issue, and the
//     FFMA peak above is its ceiling.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TL = 4;            // output time steps per thread
constexpr int TC = 4;            // output channels per thread
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float elu(float v) {
  // the Pallas kernel's ELU (conv_stack.py:45-47)
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

// One layer of one batch row.
//   FROM_GLOBAL: src is x[b], (L, cin) without halo; rows outside [0, L) are 0.
//   otherwise:   src is a shared buffer (L+K-1, cin) whose halo rows are 0,
//                so output row l, tap k reads row l + k.
// w: (K*cin, Cp) f32, row k*cin + ci; bias: (Cp) f32.
// Output row l, channel c goes to dst[(l + dst_off) * C + c].
template <bool FROM_GLOBAL>
__device__ __forceinline__ void conv_layer(
    const float* __restrict__ src, int cin, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ dst, int dst_off,
    int L, int C, int Cp, int K) {
  const int pad = K / 2;
  const int ntc = Cp / TC;
  const int tiles = ((L + TL - 1) / TL) * ntc;
  for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
    const int l0 = (tile / ntc) * TL;
    const int c0 = (tile % ntc) * TC;
    float acc[TL][TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const float bj = bias[c0 + j];
#pragma unroll
      for (int i = 0; i < TL; ++i) acc[i][j] = bj;
    }
    for (int k = 0; k < K; ++k) {
      const float* wk = w + (size_t)k * cin * Cp + c0;
      // row of src feeding output row l0 + i at this tap, or -1 for zero
      int row[TL];
#pragma unroll
      for (int i = 0; i < TL; ++i) {
        const int l = l0 + i;
        if (FROM_GLOBAL) {
          const int t = l + k - pad;
          row[i] = (l < L && t >= 0 && t < L) ? t : -1;
        } else {
          row[i] = l < L ? l + k : -1;
        }
      }
#pragma unroll 4
      for (int ci = 0; ci < cin; ++ci) {
        const float4 wq = __ldg(reinterpret_cast<const float4*>(wk + (size_t)ci * Cp));
        const float wv[TC] = {wq.x, wq.y, wq.z, wq.w};
        float a[TL];
#pragma unroll
        for (int i = 0; i < TL; ++i)
          a[i] = row[i] >= 0 ? src[(size_t)row[i] * cin + ci] : 0.f;
#pragma unroll
        for (int i = 0; i < TL; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TL; ++i) {
      const int l = l0 + i;
      if (l >= L) break;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = c0 + j;
        if (c < C) dst[(size_t)(l + dst_off) * C + c] = elu(acc[i][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
conv_stack_f32_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                      const float* __restrict__ b0, const float* __restrict__ wr,
                      const float* __restrict__ br, float* __restrict__ out,
                      int L, int Cin, int C, int Cp, int K, int num_layer) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pad = K / 2;
  const int Lp = L + K - 1;
  float* buf0 = reinterpret_cast<float*>(smem_raw);
  float* buf1 = buf0 + (size_t)Lp * C;
  const float* xb = x + (size_t)blockIdx.x * L * Cin;
  float* ob = out + (size_t)blockIdx.x * L * C;

  if (num_layer == 1) {
    conv_layer<true>(xb, Cin, w0, b0, ob, 0, L, C, Cp, K);
    return;
  }
  // zero the K-1 halo rows of both buffers: rows [0, pad) and [pad+L, Lp)
  for (int i = threadIdx.x; i < (K - 1) * C; i += blockDim.x) {
    const int r = i / C;
    const int row = r < pad ? r : L + r;
    buf0[(size_t)row * C + i % C] = 0.f;
    buf1[(size_t)row * C + i % C] = 0.f;
  }
  conv_layer<true>(xb, Cin, w0, b0, buf0, pad, L, C, Cp, K);
  __syncthreads();
  for (int layer = 1; layer < num_layer; ++layer) {
    const float* src = (layer & 1) ? buf0 : buf1;
    float* dst = (layer & 1) ? buf1 : buf0;
    const bool last = layer == num_layer - 1;
    conv_layer<false>(src, C, wr + (size_t)(layer - 1) * K * C * Cp,
                      br + (size_t)(layer - 1) * Cp, last ? ob : dst,
                      last ? 0 : pad, L, C, Cp, K);
    __syncthreads();
  }
}

}  // namespace

// x (B, L, Cin) f32; w0 (K*Cin, Cp) f32; b0 (Cp) f32; wr (num_layer-1, K*C,
// Cp) f32 and br (num_layer-1, Cp) f32, NULL when num_layer == 1; out
// (B, L, C) f32. All contiguous; w0 and wr 16-byte aligned, Cp = C rounded up
// to a multiple of 4 with zero-filled columns.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int conv_stack_f32_launch(const void* x, const void* w0,
                                     const void* b0, const void* wr,
                                     const void* br, void* out, int B, int L,
                                     int Cin, int C, int Cp, int K,
                                     int num_layer, void* stream) {
  // a single layer writes straight to `out` and needs no buffers
  const size_t smem =
      num_layer > 1 ? 2 * (size_t)(L + K - 1) * C * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_stack_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = ((L + TL - 1) / TL) * (Cp / TC);
  const int rounds = (tiles + MAX_THREADS - 1) / MAX_THREADS;
  int threads = (tiles + rounds - 1) / rounds;
  threads = (threads + 31) / 32 * 32;
  conv_stack_f32_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w0, (const float*)b0, (const float*)wr,
      (const float*)br, (float*)out, L, Cin, C, Cp, K, num_layer);
  return (int)cudaGetLastError();
}
