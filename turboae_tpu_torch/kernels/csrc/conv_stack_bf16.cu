// Fused same-length Conv1d + ELU stack in bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces turboae_tpu/kernels/conv_stack.py::_fused_forward_im2col (Pallas
// body _stack_kernel_im2col). What it computes, per batch row b:
//   h_0 = x[b]                                  (L, Cin), bf16
//   h_n = bf16(ELU(sum_k h_{n-1}[l + k - K/2] @ W_n[k] + bias_n))   zero padding
// with bf16 operands, f32 accumulation, bias and ELU (exp(min(v,0)) - 1) in
// f32, bf16 between layers and at the output. Only the last layer is written
// to device memory.
//
// Bound: at the decoder's shape (B=2000, L=100, Cin=7, C=100, K=5, 5 layers)
// a call does 2*B*L*(K*Cin*C + 4*K*C*C) = 8.1e10 FLOP on 43 MB of input,
// output and weights: 1900 FLOP per byte, far above the H100's 295 FLOP/byte
// bf16 ridge, so the tensor cores' rate bounds it (82 us at 989 TFLOP/s).
//
// Layout (the Pallas kernel's im2col fold, with no im2col buffer):
//   - a block holds R batch rows. Each activation buffer is flat with row
//     stride S = C rounded up to 8 (and to an odd multiple of 8, so the eight
//     rows an ldmatrix reads fall in distinct banks): the R rows of (L+K-1)
//     time steps, K/2 zero halo rows before and after each, follow one another.
//     Output row m of a layer then reads the contiguous span
//     buf[m*S, m*S + Kc) as its A row (Kc = K*S rounded up to 16), and one
//     M = R*(L+K-1) - (K-1) row GEMM covers every batch row of the block; the
//     rows that straddle two batch rows are computed and never written;
//   - the weights are one (Kc, SW) matrix W' per layer, W'[k*S + ci, c] =
//     W[c, ci, k], zero where ci >= C or c >= C (packed by the wrapper), SW
//     columns wide so that every warp's 13 n8 tiles lie inside it; its zero
//     columns and zero bias keep the padded channels at ELU(0) = 0;
//   - layer 0 reads x from its own buffer of stride S0 (Cin rounded the same
//     way; 8 for Cin=7), filled from device memory with scalar loads;
//   - every buffer is zeroed once, so halo rows, padded channels and the up
//     to Kc - K*S values the last rows read past their taps are 0, never NaN;
//     only valid rows are written afterwards.
// Compute: each warp owns 2 m16 tiles x 13 n8 tiles of f32 accumulators
// (M padded to whole warps, so the inner loop has no branch) and runs
// mma.sync.m16n8k16 (bf16 in, f32 out) on fragments from ldmatrix; the A
// operand stays in shared memory for the whole stack, the weights stream
// through a three-stage cp.async ring of 16*kch contraction rows that every
// warp reuses for all its rows, two chunks ahead, across layer boundaries.
// The epilogue adds the bias (staged in shared memory), applies ELU and
// rounds to bf16 on the accumulator fragments and writes the next layer's
// buffer; the last layer writes its valid rows and C columns straight to
// `out` (scalar stores where C is odd).
// Registers bound the block: 104 accumulators a thread, 168 registers at 12
// warps, so at C=100 a block holds three batch rows (10 warps, 180 KB of
// shared memory, one block an SM); the wrapper may take fewer rows where
// that needs no more rounds of blocks over the SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int WM = 2;              // m16 tiles per warp
constexpr int WN = 13;             // n8 tiles per warp
constexpr int MAX_WARPS = 12;
constexpr int STAGES = 3;          // weight ring
constexpr int SMEM_LIMIT = 232448;

// The block's layout; mirrors kernels/conv_stack.py::K2Plan field by field.
struct Plan {
  int L, Cin, C, K, num_layer, R, P, S, S0, SW, Kc, Kc0, mtiles, ngroups, kch,
      rows_alloc, rows_alloc0;
};

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float elu(float v) {
  // the Pallas kernel's ELU (conv_stack.py:45-47), exp(min(v, 0)) - 1, with
  // exp as the hardware's ex2.approx (relative error ~2^-22, far below the
  // bf16 rounding that follows): the epilogue is on the critical path, since
  // every warp runs it at once
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fminf(v, 0.f) * 1.4426950408889634f));
  return v > 0.f ? v : e - 1.f;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t a, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t a, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t a, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most STAGES - 2 groups of copies are in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
conv_stack_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                       const float* __restrict__ b0, const bf16* __restrict__ wr,
                       const float* __restrict__ br, bf16* __restrict__ out, int B,
                       const Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + (size_t)p.rows_alloc * p.S;
  bf16* xbuf = buf1 + (size_t)p.rows_alloc * p.S;
  bf16* ring = xbuf + (size_t)p.rows_alloc0 * p.S0;
  const int chunk_rows = 16 * p.kch;
  const int stage = chunk_rows * p.SW;          // values in one ring stage
  float* sbias = reinterpret_cast<float*>(ring + (size_t)STAGES * stage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * p.R;
  const int Rv = min(p.R, B - r0);              // batch rows this block holds
  const int pad = p.K / 2;
  const int nch0 = (p.Kc0 + chunk_rows - 1) / chunk_rows;
  const int nchr = (p.Kc + chunk_rows - 1) / chunk_rows;
  const int T = nch0 + (p.num_layer - 1) * nchr;   // weight chunks of the stack

  // chunk t of the stack: copy its rows of W' into ring stage t % STAGES
  auto issue = [&](int t) {
    if (t < T) {
      const int layer = t < nch0 ? 0 : 1 + (t - nch0) / nchr;
      const int c = t < nch0 ? t : (t - nch0) % nchr;
      const int Kl = layer ? p.Kc : p.Kc0;
      const bf16* src = (layer ? wr + (size_t)(layer - 1) * p.Kc * p.SW : w0) +
                        (size_t)c * stage;
      const uint32_t dst = saddr(ring + (size_t)(t % STAGES) * stage);
      const int units = min(chunk_rows, Kl - c * chunk_rows) * p.SW / 8;
      for (int u = tid; u < units; u += blockDim.x) cp_async16(dst + 16 * u, src + 8 * u);
    }
    cp_async_commit();    // one group per chunk, empty past the end
  };

  // every layer's bias joins the first chunk's copies, then the ring fills
  for (int u = tid; u < p.num_layer * p.SW / 4; u += blockDim.x)
    cp_async16(saddr(sbias + 4 * u), u < p.SW / 4 ? b0 + 4 * u : br + 4 * u - p.SW);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  // zero both buffers and x's: halos, padded channels, tails, absent rows
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n = (2 * p.rows_alloc * p.S + p.rows_alloc0 * p.S0) / 8;
    for (int i = tid; i < n; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  // x's rows (Cin may be odd: scalar copies), eight loads in flight a thread
  {
    const int row = p.L * p.Cin, n = Rv * row;
    const bf16* xb = x + (size_t)r0 * row;
    for (int e0 = tid; e0 < n; e0 += 8 * blockDim.x) {
      bf16 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * blockDim.x;
        v[u] = e < n ? xb[e] : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < n) {
          const int r = e / row, l = (e - r * row) / p.Cin, ci = e - r * row - l * p.Cin;
          xbuf[(size_t)(r * p.P + pad + l) * p.S0 + ci] = v[u];
        }
      }
    }
  }

  // this warp's tiles: m16 tiles [mt0, mt0 + WM), n8 tiles [nt0, nt0 + WN)
  const int mt0 = (warp / p.ngroups) * WM;
  const int nt0 = (warp % p.ngroups) * WN;

  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  int layer = 0, c = 0;     // chunk t is chunk c of `layer`
  for (int t = 0; t < T; ++t) {
    cp_async_wait_ring();
    __syncthreads();        // chunk t landed; stage (t-1) % STAGES and the last epilogue are done
    issue(t + STAGES - 1);

    const int Ss = layer ? p.S : p.S0;
    const bf16* src = layer == 0 ? xbuf : ((layer - 1) & 1 ? buf1 : buf0);
    const int k0 = c * chunk_rows;
    const int ksteps = min(chunk_rows, (layer ? p.Kc : p.Kc0) - k0) / 16;
    // ldmatrix row addresses: A rows m = tile*16 + lane%16 at k + 8*(lane/16);
    // B rows k + lane%8 + 8*(lane/8 % 2) at column tile nt0 + j + lane/16
    const uint32_t a_base =
        saddr(src + (size_t)(mt0 * 16 + (lane & 15)) * Ss + k0 + (lane >> 4) * 8);
    const uint32_t b_base =
        saddr(ring + (size_t)(t % STAGES) * stage +
              (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * p.SW + (nt0 + (lane >> 4)) * 8);
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[WM][4], b[WN + 1][2];
#pragma unroll
      for (int i = 0; i < WM; ++i) ldsm_x4(a_base + 2 * (i * 16 * Ss + ks * 16), a[i]);
      const uint32_t bk = b_base + 2 * ks * 16 * p.SW;
#pragma unroll
      for (int j = 0; j < WN; j += 2) {
        uint32_t r[4];
        if (j + 1 < WN) ldsm_x4_t(bk + 2 * j * 8, r);
        else ldsm_x2_t(bk + 2 * j * 8, r);
        b[j][0] = r[0]; b[j][1] = r[1]; b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int i = 0; i < WM; ++i) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }

    if (++c < (layer ? nchr : nch0)) continue;
    // epilogue of `layer`: bias, ELU and bf16 on the fragments, valid rows
    // only; into the next buffer's S columns, or the last layer's C columns
    // straight to `out`
    const float* bias = sbias + layer * p.SW;
    bf16* dst = layer & 1 ? buf1 : buf0;
    const bool last = layer == p.num_layer - 1;
    float bn[WN][2];
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      const int n = (nt0 + j) * 8 + 2 * (lane & 3);
      bn[j][0] = bias[n];
      bn[j][1] = bias[n + 1];
    }
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mt0 + i) * 16 + (lane >> 2) + 8 * h;
        const int r = m / p.P, l = m - r * p.P;
        if (r >= Rv || l >= p.L) continue;
        bf16* drow = last ? out + ((size_t)(r0 + r) * p.L + l) * p.C
                          : dst + (size_t)(m + pad) * p.S;
        const int width = last ? p.C : p.S;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int n = (nt0 + j) * 8 + 2 * (lane & 3);
          if (n >= width) continue;
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(elu(acc[i][j][2 * h] + bn[j][0]),
                                    elu(acc[i][j][2 * h + 1] + bn[j][1]));
          if (n + 1 < width && !(last && (p.C & 1))) {
            *reinterpret_cast<__nv_bfloat162*>(drow + n) = v;   // 4-byte aligned
          } else {
            drow[n] = v.x;
            if (n + 1 < width) drow[n + 1] = v.y;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    }
    ++layer;
    c = 0;
  }
}

}  // namespace

// x (B, L, Cin) bf16; w0 (Kc0, SW) bf16; b0 (SW) f32; wr (num_layer-1, Kc,
// SW) bf16 and br (num_layer-1, SW) f32, NULL when num_layer == 1; out
// (B, L, C) bf16. All contiguous and 16-byte aligned, in the layout described
// above. `plan` holds the n_plan ints of struct Plan, from
// kernels/conv_stack.py::K2Plan. Launches ceil(B / R) blocks on `stream` and
// returns a CUDA error code (0 on success).
extern "C" int conv_stack_bf16_launch(const void* x, const void* w0, const void* b0,
                                      const void* wr, const void* br, void* out,
                                      int B, const int* plan, int n_plan,
                                      void* stream) {
  Plan p;
  if (n_plan != (int)(sizeof(Plan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  memcpy(&p, plan, sizeof(p));
  const int nwarps = p.mtiles / WM * p.ngroups;
  const size_t smem = 2 * ((size_t)2 * p.rows_alloc * p.S + (size_t)p.rows_alloc0 * p.S0 +
                           (size_t)STAGES * 16 * p.kch * p.SW) +
                      4 * (size_t)p.num_layer * p.SW;
  if (nwarps > MAX_WARPS || p.mtiles % WM || p.SW < p.ngroups * WN * 8 || p.S % 8 ||
      p.S0 % 8 || p.SW % 8 || smem > SMEM_LIMIT ||
      (p.num_layer > 1 && (wr == nullptr || br == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_stack_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  conv_stack_bf16_kernel<<<(B + p.R - 1) / p.R, nwarps * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w0, (const float*)b0, (const bf16*)wr,
      (const float*)br, (bf16*)out, B, p);
  return (int)cudaGetLastError();
}
