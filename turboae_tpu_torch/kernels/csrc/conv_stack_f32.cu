// Fused same-length Conv1d + ELU stack in f32 on Hopper's tensor cores
// (sm_90a), by 3xTF32.
//
// Replaces turboae_tpu/kernels/conv_stack.py::_fused_forward (Pallas body
// _stack_kernel). What it computes, per batch row b:
//   h_0 = x[b]                                  (L, Cin), f32
//   h_n = ELU(sum_k h_{n-1}[l + k - K/2] @ W_n[k] + bias_n)   zero padding
// with f32 in and out, bias and ELU (exp(min(v,0)) - 1 with the full expf,
// as the Pallas kernel) in f32. Only the last layer is written to device
// memory.
//
// Arithmetic (3xTF32): a TF32 operand keeps 11 significant bits, so one
// TF32 product is ~6e-4 away from the f32 result here, 30x the Pallas f32
// kernel's tolerance of 2e-5. Each operand a is split in registers into
// big = rna(a) and small = rna(a - big), rna being TF32's round to nearest
// with ties away from zero (cvt.rna.tf32.f32), and each product is summed
// in f32 as small*big + big*small + big*big by three mma.sync.m16n8k8 TF32
// -> f32. The small*small term left out is below 2^-22 of the product.
// The tensor cores' f32 sums do not round to nearest: run straight into the
// layer's accumulators, the three MMAs of every k-step put a one-sided error
// on the growing sum, 1.1e-5 relative at the bench's shape and 2.9e-5 at
// C=256 (NVIDIA H100 80GB HBM3, 700.00 W; cli/k1_variants.py, no_fold). So
// each k-step's three MMAs start from zero, and an FADD, which rounds to
// nearest, adds their sum to the accumulator: 6.4e-7 and 1.1e-6.
//
// Bound: at the conv-stack bench's shape (B=500, L=100, Cin=7, C=100, K=5,
// 5 layers) a call does 2*B*L*(K*Cin*C + 4*K*C*C) = 2.035e10 FLOP, three
// TF32 products each: 0.123 ms at the H100 SXM's 495 TFLOP/s (TF32, dense),
// against 0.304 ms for exact f32 on the CUDA cores (67 TFLOP/s) and 0.007 ms
// for its 22 MB of input, output and weights at 3.35 TB/s.
//
// Layout (K2's, conv_stack_bf16.cu, in f32):
//   - a block holds R batch rows in one flat activation buffer of row stride
//     S = C rounded up to an odd multiple of 4 (an ldmatrix row is 16 bytes,
//     four floats; the odd multiple puts the eight rows one ldmatrix reads in
//     distinct banks): the R rows of L+K-1 time steps, K/2 zero halo rows
//     before and after each, follow one another. Output row m of a layer
//     reads the contiguous span buf[m*S, m*S + Kc) as its A row (Kc = K*S
//     rounded up to 8), so one M = R*(L+K-1) - (K-1) row product covers the
//     block; the rows that straddle two batch rows are computed and never
//     written;
//   - a non-transposing ldmatrix on f32 rows gives the m16n8k8 TF32 A
//     fragment as it is (lane t receives word t%4 of row t/4). ldmatrix
//     cannot transpose 32-bit values, so the weights are packed n-major, one
//     (NW, Kc) matrix W' per layer, W'[c][k*S + ci] = W[c, ci, k], zero where
//     ci >= C, c >= C or past K*S (packed by the wrapper); the B fragment is
//     then a non-transposing ldmatrix too. NW covers every warp's 13 n8
//     tiles; its zero rows and zero bias give the padded channels, which
//     are never written;
//   - one activation buffer: every warp holds its output tile in registers
//     until the layer's contraction ends, so after a barrier the epilogue
//     overwrites the buffer in place. Layer 0 reads x from its own buffer of
//     stride S0 (12 for Cin=7), filled from device memory with scalar loads
//     (x's rows are 28 bytes);
//   - both buffers are zeroed once, so halo rows, padded channels and the up
//     to Kc - K*S values the last rows read past their taps are 0, never
//     NaN; only valid rows and the C real channels are written afterwards.
// Compute: each warp owns 2 m16 tiles x 13 n8 tiles of f32 accumulators (M
// padded to whole warps, so the inner loop has no branch). The weights
// stream as one f32 plane through a three-stage cp.async ring of kch
// contraction columns (NW rows of kch floats, row stride kch + 4, odd in
// 16-byte units), two chunks ahead, across layer boundaries; both operands
// are split after ldmatrix, so each loaded fragment feeds three MMAs. The
// epilogue adds the bias (staged in shared memory) and applies ELU on the
// accumulator fragments; the last layer writes its valid rows and C columns
// straight to `out` (scalar stores where C is odd).
// Registers bound the block: 104 accumulators a thread, and the k-step's
// fragments, splits and fresh sums beside them. The kernel is built twice:
// for blocks of up to 8 warps with up to 255 registers a thread, where
// ptxas keeps enough of the k-step's sums in flight (0.53 ms at the bench's
// shape against 0.62 ms at 168, on the card above; cli/k1_variants.py,
// regs168), and for 9 to 12 warps with 168.
// At C=100 a block holds at most three batch rows (10 warps, 193 KB of
// shared memory, one block an SM); the wrapper takes fewer rows where that
// needs no more rounds of blocks over the SMs: two at B=500, 7 warps.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int WM = 2;              // m16 tiles per warp
constexpr int WN = 13;             // n8 tiles per warp
constexpr int MAX_WARPS = 12;
constexpr int WIDE_REG_WARPS = 8;  // blocks of at most 8 warps: up to 255 registers a thread
constexpr int STAGES = 3;          // weight ring
constexpr int SMEM_LIMIT = 232448;

// The block's layout; mirrors kernels/conv_stack.py::K1Plan field by field.
struct Plan {
  int L, Cin, C, K, num_layer, R, P, S, S0, NW, SK, Kc, Kc0, mtiles, ngroups, kch,
      rows_alloc, rows_alloc0;
};

__device__ __forceinline__ float elu(float v) {
  // the Pallas kernel's ELU (conv_stack.py:45-47), with the full expf
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

// TF32 round to nearest, ties away from zero, on the bits: equal to
// cvt.rna.tf32.f32 for every finite value, with the low 13 bits 0. ptxas
// turns cvt.rna into a NaN test, an add, a mask and a select; this is an add
// and a mask
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// 3xTF32 split of one fragment register: a = big + small + O(2^-22 a)
__device__ __forceinline__ void split(uint32_t a, uint32_t& big, uint32_t& small) {
  big = tf32_rna(__uint_as_float(a));
  small = tf32_rna(__uint_as_float(a) - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t a, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t a, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

template <int MAXW>
__global__ void __launch_bounds__(MAXW * 32, 1)
conv_stack_f32_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                      const float* __restrict__ b0, const float* __restrict__ wr,
                      const float* __restrict__ br, float* __restrict__ out, int B,
                      const Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  float* xbuf = buf + (size_t)p.rows_alloc * p.S;
  float* ring = xbuf + (size_t)p.rows_alloc0 * p.S0;
  const int stage = p.NW * p.SK;                // floats in one ring stage
  float* sbias = ring + (size_t)STAGES * stage;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * p.R;
  const int Rv = min(p.R, B - r0);              // batch rows this block holds
  const int pad = p.K / 2;
  const int nch0 = (p.Kc0 + p.kch - 1) / p.kch;
  const int nchr = (p.Kc + p.kch - 1) / p.kch;
  const int T = nch0 + (p.num_layer - 1) * nchr;   // weight chunks of the stack

  // chunk t of the stack: columns [c*kch, c*kch + kch) of every row of W'
  // into ring stage t % STAGES
  auto copy_chunk = [&](int t) {
    if (t < T) {
      const int layer = t < nch0 ? 0 : 1 + (t - nch0) / nchr;
      const int c = t < nch0 ? t : (t - nch0) % nchr;
      const int Kl = layer ? p.Kc : p.Kc0;
      const float* src = (layer ? wr + (size_t)(layer - 1) * p.NW * p.Kc : w0) + c * p.kch;
      const uint32_t dst = saddr(ring + (size_t)(t % STAGES) * stage);
      const int q = min(p.kch, Kl - c * p.kch) / 4;   // 16-byte units in a row
      for (int u = tid; u < p.NW * q; u += blockDim.x) {
        const int n = u / q, j = u - n * q;
        cp_async16(dst + 4 * (n * p.SK + 4 * j), src + (size_t)n * Kl + 4 * j);
      }
    }
    cp_async_commit();    // one group per chunk, empty past the end
  };

  // every layer's bias joins the first chunk's copies, then the ring fills
  for (int u = tid; u < p.num_layer * p.NW / 4; u += blockDim.x)
    cp_async16(saddr(sbias + 4 * u), u < p.NW / 4 ? b0 + 4 * u : br + 4 * u - p.NW);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) copy_chunk(t);

  // zero the activation buffer and x's: halos, padded channels, tails, absent rows
  {
    float4* z = reinterpret_cast<float4*>(smem);
    const int n = (p.rows_alloc * p.S + p.rows_alloc0 * p.S0) / 4;
    for (int i = tid; i < n; i += blockDim.x) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  // x's rows (28 bytes at Cin=7: scalar copies), eight loads in flight a thread
  {
    const int row = p.L * p.Cin, n = Rv * row;
    const float* xb = x + (size_t)r0 * row;
    for (int e0 = tid; e0 < n; e0 += 8 * blockDim.x) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * blockDim.x;
        v[u] = e < n ? xb[e] : 0.f;
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
    copy_chunk(t + STAGES - 1);

    const int Ss = layer ? p.S : p.S0;
    const float* src = layer ? buf : xbuf;
    const int k0 = c * p.kch;
    const int ksteps = min(p.kch, (layer ? p.Kc : p.Kc0) - k0) / 8;
    // ldmatrix row addresses: A rows m = tile*16 + lane%16 at k + 4*(lane/16);
    // B rows n = (nt0 + j + lane/16)*8 + lane%8 at k + 4*(lane/8 % 2)
    const uint32_t a_base =
        saddr(src + (size_t)(mt0 * 16 + (lane & 15)) * Ss + k0 + (lane >> 4) * 4);
    const uint32_t b_base =
        saddr(ring + (size_t)(t % STAGES) * stage +
              (size_t)(nt0 * 8 + (lane & 7) + (lane >> 4) * 8) * p.SK + ((lane >> 3) & 1) * 4);
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t ab[WM][4], as[WM][4];
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        uint32_t r[4];
        ldsm_x4(a_base + 4 * (i * 16 * Ss + ks * 8), r);
#pragma unroll
        for (int q = 0; q < 4; ++q) split(r[q], ab[i][q], as[i][q]);
      }
      const uint32_t bk = b_base + 4 * ks * 8;
#pragma unroll
      for (int j = 0; j < WN; j += 2) {
        uint32_t r[4];
        if (j + 1 < WN) ldsm_x4(bk + 4 * j * 8 * p.SK, r);
        else ldsm_x2(bk + 4 * j * 8 * p.SK, r);
#pragma unroll
        for (int h = 0; h < 2 && j + h < WN; ++h) {
          uint32_t bb[2], bs[2];
          split(r[2 * h], bb[0], bs[0]);
          split(r[2 * h + 1], bb[1], bs[1]);
#pragma unroll
          for (int i = 0; i < WM; ++i) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, as[i], bb);
            mma_tf32(d, ab[i], bs);
            mma_tf32(d, ab[i], bb);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j + h][q] += d[q];
          }
        }
      }
    }

    if (++c < (layer ? nchr : nch0)) continue;
    // epilogue of `layer`: bias and ELU on the fragments, valid rows and the
    // C real channels only; in place into the buffer once every warp has
    // read it, or for the last layer straight to `out`
    const float* bias = sbias + layer * p.NW;
    const bool last = layer == p.num_layer - 1;
    if (layer > 0 && !last) __syncthreads();
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
        float* drow = last ? out + ((size_t)(r0 + r) * p.L + l) * p.C
                           : buf + (size_t)(m + pad) * p.S;
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const int n = (nt0 + j) * 8 + 2 * (lane & 3);
          if (n >= p.C) continue;
          const float v0 = elu(acc[i][j][2 * h] + bn[j][0]);
          const float v1 = elu(acc[i][j][2 * h + 1] + bn[j][1]);
          if (n + 1 < p.C && !(last && (p.C & 1))) {
            *reinterpret_cast<float2*>(drow + n) = make_float2(v0, v1);   // 8-byte aligned
          } else {
            drow[n] = v0;
            if (n + 1 < p.C) drow[n + 1] = v1;
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

// x (B, L, Cin) f32; w0 (NW, Kc0) f32; b0 (NW) f32; wr (num_layer-1, NW, Kc)
// f32 and br (num_layer-1, NW) f32, NULL when num_layer == 1; out (B, L, C)
// f32. All contiguous and 16-byte aligned, in the layout described above.
// `plan` holds the n_plan ints of struct Plan, from
// kernels/conv_stack.py::K1Plan. Launches ceil(B / R) blocks on `stream` and
// returns a CUDA error code (0 on success).
extern "C" int conv_stack_f32_launch(const void* x, const void* w0, const void* b0,
                                     const void* wr, const void* br, void* out,
                                     int B, const int* plan, int n_plan,
                                     void* stream) {
  Plan p;
  if (n_plan != (int)(sizeof(Plan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  memcpy(&p, plan, sizeof(p));
  const int nwarps = p.mtiles / WM * p.ngroups;
  const size_t smem = 4 * ((size_t)p.rows_alloc * p.S + (size_t)p.rows_alloc0 * p.S0 +
                           (size_t)STAGES * p.NW * p.SK + (size_t)p.num_layer * p.NW);
  if (nwarps > MAX_WARPS || p.mtiles % WM || p.NW < p.ngroups * WN * 8 || p.NW % 4 ||
      p.C > p.NW || p.C > p.S || p.S % 4 || p.S0 % 4 || p.kch % 8 || p.SK < p.kch ||
      p.SK % 4 || p.Kc % 8 || p.Kc0 % 8 || smem > SMEM_LIMIT ||
      (p.num_layer > 1 && (wr == nullptr || br == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto kernel = nwarps <= WIDE_REG_WARPS ? conv_stack_f32_kernel<WIDE_REG_WARPS>
                                         : conv_stack_f32_kernel<MAX_WARPS>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(B + p.R - 1) / p.R, nwarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w0, (const float*)b0, (const float*)wr,
      (const float*)br, (float*)out, B, p);
  return (int)cudaGetLastError();
}
