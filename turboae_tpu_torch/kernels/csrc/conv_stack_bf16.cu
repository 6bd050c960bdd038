// Fused same-length Conv1d + ELU stack in bf16 on Hopper's warpgroup tensor
// cores (sm_90a).
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
// bf16 ridge, so the tensor cores' rate bounds it: 0.082 ms at 989.4 TFLOP/s.
//
// Layout (the Pallas kernel's im2col fold, with no im2col buffer):
//   - a block holds up to R batch rows. Each activation buffer is flat with
//     row stride S = C rounded up to an odd multiple of 8 (16-byte rows whose
//     eight ldmatrix rows fall in distinct banks): the rows of (L+K-1) time
//     steps, K/2 zero halo rows before and after each, follow one another.
//     Output row m of a layer reads the contiguous span buf[m*S, m*S + Kc) as
//     its A row (Kc = K*S rounded up to 16), so one M = Rv*(L+K-1) - (K-1)
//     row product covers every batch row of the block; the rows that straddle
//     two batch rows are computed and never written;
//   - layer 0 reads x from its own buffer of stride S0 (Cin rounded the same
//     way; 8 for Cin=7); layers then alternate between two buffers, so a
//     layer's epilogue never overwrites what a slower warpgroup still reads;
//   - the weights of a layer are W'[k*S + ci, c] = W[c, ci, k] (zero where
//     ci >= C, c >= C or k*S + ci >= K*S), cut into column groups of N
//     columns (N = C rounded up to one of 32, 104, 128, 256; wider C
//     takes several groups of 256) and chunks of 64 contraction rows. A chunk
//     is N*128 contiguous bytes in wgmma's K-major 128-byte-swizzle layout,
//     packed by the wrapper: element (k, n) at (n/8)*1024 + (n%8)*128 +
//     ((k/8) ^ (n%8))*16 + (k%8)*2 bytes. A descriptor over the chunk (stride
//     1024 bytes between 8-row groups) plus 32 bytes per k16 step reads it.
//
// Work: NC consumer warpgroups, one m64 tile of the block's rows each, and
// a producer warpgroup of which one warp works. It streams the stack's
// chunks, in the order the consumers use them, through a ring of up to 4
// stages (fewer where the buffers leave no room) with one bulk copy each
// (cp.async.bulk, TMA's 1-D form: no tensor map), each signalling a `full`
// mbarrier; the consumers release a stage on its `empty` mbarrier. The ring
// runs across column groups and layers, so the producer loads the next
// layer's weights during an epilogue. A consumer warpgroup loads its A
// fragments with ldmatrix from the fold (a shared-memory descriptor cannot
// express rows that overlap at stride S) and runs
// wgmma.mma_async.m64nNk16 with A from registers and B from the ring (n104
// as n56 and n48: see Mma<104>). Bias, ELU and bf16 run on the
// accumulators; the next layer starts after one named barrier of the
// consumers alone. The last layer's valid rows and C columns go from its
// buffer to `out` in coalesced 8-byte stores.
//
// What this does about the limits of the mma.sync design it replaces:
//   1. B reuse: one wgmma reads a k16 x N slice of B once for 64 rows, where
//      each warp fetched its own copy for 32 rows: 1.6x less shared-memory
//      traffic a product;
//   2. no block-wide barrier a chunk: consumers wait on the chunk's own
//      mbarrier, and only its readers release it;
//   3. the epilogue still stalls the tensor cores between layers, but the
//      weights keep streaming through it (the producer is never stalled by
//      it), and the output leaves in coalesced stores; overlapping
//      epilogues across warpgroups is later work;
//   4. wave tail: the wrapper spreads the batch rows evenly over a whole
//      number of rounds of blocks over the SMs (kernels/conv_stack.py:
//      k2_plan), and a block whose rows fill fewer tiles issues fewer
//      products;
//   5. weights re-streamed per block: still, through the ring, as whole
//      contiguous chunks; a cluster multicast is later work.
// Registers bound the block: the accumulators of an m64 x N tile are N/2 a
// thread (52 at C=100); __launch_bounds__ holds NC consumer warpgroups and
// the producer warpgroup in one SM's register file (80 a thread at C=100,
// five consumer warpgroups); setmaxnreg drops the producer warpgroup to 24
// and gives the consumers what that frees (88 at C=100), and a consumer
// holds the A fragments of KB k16 steps at once (2 at C=100, else 4). At
// C=100 a block holds three batch rows (308 rows of the fold in five m64
// tiles; cli/k2_variants.py measures the choices).
// The register rule, the mbarrier, bulk-copy and wgmma helpers, the ELU, the
// bf16 products (MmaBf16) and the launcher's prelude (`prepare`) are
// hopper.cuh's, shared with K1 and K3.
#include <cuda_bf16.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_STAGES = 4;      // weight ring
constexpr int CHUNK_K = 64;        // contraction rows a chunk: one 128-byte swizzle atom

// The block's layout; mirrors kernels/conv_stack.py::K2Plan field by field.
struct Plan {
  int L, Cin, C, K, num_layer, R, G, P, S, S0, N, ngroups, nc, stages, Kc, Kc0, rows_alloc,
      rows_alloc0;
};

typedef __nv_bfloat16 bf16;

// hopper.cuh's bf16 products: one wgmma a width of K2_WIDTHS, n104 as n56 + n48
template <int N>
using Mma = MmaBf16<N>;

__host__ __device__ constexpr size_t smem_bytes(const Plan& p) {
  return 1024 +                                              // alignment of the ring
         (size_t)p.stages * p.N * 128 +                      // weight ring
         2 * ((size_t)2 * p.rows_alloc * p.S + (size_t)p.rows_alloc0 * p.S0) +
         4 * (size_t)p.num_layer * p.ngroups * p.N +         // biases, f32
         16 * (size_t)p.stages;                              // full and empty mbarriers
}

template <int N, int NCMAX>
__global__ void __launch_bounds__((NCMAX + 1) * 128, 1)
conv_stack_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                       const float* __restrict__ b0, const bf16* __restrict__ wr,
                       const float* __restrict__ br, bf16* __restrict__ out, int B,
                       const Plan p) {
  constexpr int INC = consumer_regs(NCMAX);
  static_assert(NCMAX * INC + PRODUCER_REGS <= 512, "a quarter of the register file");
  static_assert(INC >= N / 2 + 32, "accumulators and A fragments");
  constexpr int KB = INC - N / 2 >= 48 ? 4 : 2;  // k16 steps whose A fragments are held at once
  constexpr int STAGE = N * 128;                 // bytes of one chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const int stages = p.stages;
  bf16* buf0 = reinterpret_cast<bf16*>(ring + (size_t)stages * STAGE);
  bf16* buf1 = buf0 + (size_t)p.rows_alloc * p.S;
  bf16* xbuf = buf1 + (size_t)p.rows_alloc * p.S;
  float* sbias = reinterpret_cast<float*>(xbuf + (size_t)p.rows_alloc0 * p.S0);
  const int GN = p.ngroups * N;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sbias + p.num_layer * GN);
  const uint32_t full = saddr(bars), empty = saddr(bars + stages);   // 8 bytes a barrier
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffff, tid >> 5, 0);   // uniform in the warp
  const int nct = p.nc * 128;                    // consumer threads
  const int nch0 = cdiv(p.Kc0, CHUNK_K), nchr = cdiv(p.Kc, CHUNK_K);
  const int T0 = p.ngroups * nch0;               // layer 0's chunks
  const int T = T0 + (p.num_layer - 1) * p.ngroups * nchr;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * p.nc);        // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if-else, whose two paths never meet again: ptxas then holds each to
  // its setmaxnreg count
  if (warp >= 4 * p.nc) {
    // ---- producer warpgroup: its first warp copies chunk t of the stack
    // into stage t % stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 4 * p.nc && lane == 0) {
      for (int t = 0; t < T; ++t) {
        const int s = t % stages;
        if (t >= stages) mbar_wait(empty + 8 * s, (t / stages - 1) & 1);
        const bf16* src = t < T0 ? w0 + (size_t)t * (STAGE / 2)
                                 : wr + (size_t)(t - T0) * (STAGE / 2);
        mbar_expect_tx(full + 8 * s, STAGE);
        bulk_copy(saddr(ring + s * STAGE), src, STAGE, full + 8 * s);
      }
    }
  } else {
    // ---- consumers
    if constexpr (INC > launch_regs(NCMAX))
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(INC));
    const int r0 = (int)((long long)blockIdx.x * B / gridDim.x);
    const int Rv = (int)((long long)(blockIdx.x + 1) * B / gridDim.x) - r0;   // rows of this block
    const int pad = p.K / 2;
    // zero both buffers and x's: halos, padded channels, tails, absent rows
    {
      uint4* z = reinterpret_cast<uint4*>(buf0);
      const int n = (2 * p.rows_alloc * p.S + p.rows_alloc0 * p.S0) / 8;
      for (int i = tid; i < n; i += nct) z[i] = make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < p.num_layer * GN; i += nct)
      sbias[i] = i < GN ? b0[i] : br[i - GN];
    consumers_sync(nct);
    // x's rows (Cin may be odd: scalar copies), eight loads in flight a thread
    {
      const int row = p.L * p.Cin, n = Rv * row;
      const bf16* xb = x + (size_t)r0 * row;
      for (int e0 = tid; e0 < n; e0 += 8 * nct) {
        bf16 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * nct;
          v[u] = e < n ? xb[e] : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * nct;
          if (e < n) {
            const int r = e / row, l = (e - r * row) / p.Cin, ci = e - r * row - l * p.Cin;
            xbuf[(size_t)(r * p.P + pad + l) * p.S0 + ci] = v[u];
          }
        }
      }
    }
    consumers_sync(nct);

    const int wg = warp >> 2;                      // this warpgroup's m64 tile
    const int m_warp = wg * 64 + (warp & 3) * 16;  // this warp's first row
    // a warpgroup whose tile holds no row of the block issues no product
    const bool active = wg * 64 < Rv * p.P - (p.K - 1);
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;   // read by the first product, which scales it by 0
    uint32_t a[KB][4];
    int t = 0;                                     // the stack's chunk counter
    for (int layer = 0; layer < p.num_layer; ++layer) {
      const int Ss = layer ? p.S : p.S0, Kl = layer ? p.Kc : p.Kc0, nch = layer ? nchr : nch0;
      const bf16* src = layer == 0 ? xbuf : (layer & 1 ? buf0 : buf1);
      bf16* dst = layer & 1 ? buf1 : buf0;
      // ldmatrix rows: A rows m_warp + lane%16 at k + 8*(lane/16)
      const uint32_t a_base = saddr(src + (size_t)(m_warp + (lane & 15)) * Ss + (lane >> 4) * 8);
      for (int g = 0; g < p.ngroups; ++g) {
        for (int c = 0; c < nch; ++c, ++t) {
          const int s = t % stages;
          mbar_wait(full + 8 * s, (t / stages) & 1);
          if (active) {
            const uint32_t ak = a_base + 2 * c * CHUNK_K;
            const uint64_t d = desc_sw128(saddr(ring + s * STAGE));
            const int nks = min(4, (Kl - c * CHUNK_K) / 16);   // k16 steps of the chunk
#pragma unroll
            for (int k0 = 0; k0 < 4; k0 += KB) {
              if (k0 >= nks) break;
#pragma unroll
              for (int i = 0; i < KB; ++i)
                if (k0 + i < nks) ldsm_x4(ak + 32 * (k0 + i), a[i]);
              wgmma_fence();
#pragma unroll
              for (int i = 0; i < KB; ++i)
                if (k0 + i < nks) Mma<N>::run(acc, a[i], d + 2 * (k0 + i), c | (k0 + i));
              wgmma_commit();
              wgmma_wait_all();      // the A registers (and, at the last, the stage) are free again
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * s);
        }
        if (!active) continue;
        // epilogue of column group g: bias, ELU and bf16 on the accumulators,
        // valid rows only, into the next buffer's S columns
        const float* bias = sbias + layer * GN + g * N;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m_warp + (lane >> 2) + 8 * h;
          const int r = m / p.P, l = m - r * p.P;
          if (r >= Rv || l >= p.L) continue;
          bf16* drow = dst + (size_t)(m + pad) * p.S;
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const int nl = j * 8 + 2 * (lane & 3), n = g * N + nl;
            if (n >= p.S) continue;
            const float2 bn = *reinterpret_cast<const float2*>(bias + nl);
            *reinterpret_cast<__nv_bfloat162*>(drow + n) =   // 4-byte aligned: S and n even
                __floats2bfloat162_rn(elu(acc[4 * j + 2 * h] + bn.x),
                                      elu(acc[4 * j + 2 * h + 1] + bn.y));
          }
        }
      }
      // the next layer (or the copy below) reads rows that other
      // warpgroups wrote
      consumers_sync(nct);
    }
    // the last layer's valid rows and C columns to `out`, where the block's
    // rows lie one after another: consecutive threads store consecutive
    // 8 bytes (single values where C is no multiple of 4)
    const bf16* res = (p.num_layer - 1) & 1 ? buf1 : buf0;
    bf16* ob = out + (size_t)r0 * p.L * p.C;
    const int LC = p.L * p.C;
    if ((p.C & 3) == 0) {
      for (int u = tid; u < Rv * LC / 4; u += nct) {
        const int e = 4 * u, r = e / LC, l = (e - r * LC) / p.C, c = e - r * LC - l * p.C;
        *reinterpret_cast<uint2*>(ob + e) =
            *reinterpret_cast<const uint2*>(res + (size_t)(r * p.P + pad + l) * p.S + c);
      }
    } else {
      for (int e = tid; e < Rv * LC; e += nct) {
        const int r = e / LC, l = (e - r * LC) / p.C, c = e - r * LC - l * p.C;
        ob[e] = res[(size_t)(r * p.P + pad + l) * p.S + c];
      }
    }
  }
}

template <int N, int NCMAX>
int launch(const void* x, const void* w0, const void* b0, const void* wr, const void* br,
           void* out, int B, const Plan& p, cudaStream_t stream) {
  constexpr auto kernel = conv_stack_bf16_kernel<N, NCMAX>;
  if (const int e = prepare<kernel, NCMAX>(p.nc)) return e;
  const size_t smem = smem_bytes(p);
  kernel<<<p.G, (p.nc + 1) * 128, smem, stream>>>(
      (const bf16*)x, (const bf16*)w0, (const float*)b0, (const bf16*)wr, (const float*)br,
      (bf16*)out, B, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L, Cin) bf16; w0 (ngroups, ceil(Kc0/64), N*64) bf16 chunks; b0
// (ngroups*N) f32; wr (num_layer-1, ngroups, ceil(Kc/64), N*64) bf16 and br
// (num_layer-1, ngroups*N) f32, NULL when num_layer == 1; out (B, L, C) bf16.
// All contiguous and 16-byte aligned, in the layout described above. `plan`
// holds the n_plan ints of struct Plan, from kernels/conv_stack.py::K2Plan.
// Launches G blocks of nc consumer warpgroups and a producer warpgroup on
// `stream`, block i taking batch rows [i*B/G, (i+1)*B/G); returns a CUDA
// error code (0 on success).
extern "C" int conv_stack_bf16_launch(const void* x, const void* w0, const void* b0,
                                      const void* wr, const void* br, void* out,
                                      int B, const int* plan, int n_plan,
                                      void* stream) {
  Plan p;
  if (n_plan != (int)(sizeof(Plan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  memcpy(&p, plan, sizeof(p));
  if (p.S % 8 || p.S0 % 8 || p.G < 1 || p.G > B || (B + p.G - 1) / p.G > p.R ||
      smem_bytes(p) > SMEM_LIMIT || (p.num_layer > 1 && (wr == nullptr || br == nullptr)) ||
      p.nc * 64 < p.R * p.P - (p.K - 1) || p.Kc % 16 || p.Kc0 % 16 || p.stages < 2 ||
      p.stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.N) {   // kernels/conv_stack.py K2_WIDTHS: N -> most consumer warpgroups
    case 32: return launch<32, 7>(x, w0, b0, wr, br, out, B, p, s);
    case 104: return launch<104, 5>(x, w0, b0, wr, br, out, B, p, s);
    case 128: return launch<128, 4>(x, w0, b0, wr, br, out, B, p, s);
    case 256: return launch<256, 2>(x, w0, b0, wr, br, out, B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
