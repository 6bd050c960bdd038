// Fused same-length Conv1d + ELU stack in f32 on Hopper's warpgroup tensor
// cores (sm_90a), by 3xTF32.
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
// kernel's tolerance of 2e-5. Each operand a is split into big = rna(a) and
// small = rna(a - big), rna being TF32's round to nearest with ties away
// from zero, and each product is summed in f32 as small*big + big*small +
// big*big by three wgmma m64nNk8 TF32 -> f32. The small*small term left out
// is below 2^-22 of the product. The weights come split: the wrapper packs a
// big and a small plane. The activations are split in registers.
// The tensor cores' f32 sums do not round to nearest: run straight into the
// layer's accumulators, the three products of every k8 step put a one-sided
// error on the growing sum, 1.1e-5 relative at the bench's shape and 3.0e-5
// at C=256, over the 2e-5 limit (NVIDIA H100 80GB HBM3, 700.00 W;
// cli/k1_variants.py, no_fold). So each ring chunk's products (four k8
// steps, three products each) run into a partial set of accumulators from
// zero, and FADDs, which round to nearest, add it to the tile's
// accumulators: 1.0e-6 and 1.2e-6. A fold every k8 step gives 0.6e-6 and
// 1.0e-6 but waits for the products every step: 35 % slower.
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
//     written. Layer 0 reads x from its own buffer of stride S0 (12 for
//     Cin=7);
//   - A comes by ldmatrix into registers (a descriptor cannot express rows
//     that overlap at stride S): on f32 rows a non-transposing ldmatrix gives
//     the k8 TF32 A fragment as it is (lane t receives word t%4 of row t/4),
//     the layout of mma.m16n8k8's A fragment, which wgmma's is too;
//   - the weights of a layer are W'[k*S + ci, c] = W[c, ci, k] (zero where
//     ci >= C, c >= C or k*S + ci >= K*S), cut into chunks of 32 contraction
//     rows and column groups of N columns (N = C rounded up to one of 32,
//     104, 128; above 128 several groups of at most 128). TF32 has no
//     transposed B, and K-major is what the packer gives: chunk (c, g) is two
//     planes, big then small, of N*128 bytes each in wgmma's 128-byte-swizzle
//     layout: element (k, n) at (n/8)*1024 + (n%8)*128 + ((k/4) ^ (n%8))*16
//     + (k%4)*4 bytes. A descriptor over a plane (stride 1024 bytes between
//     8-row groups) plus 32 bytes per k8 step reads it;
//   - one activation buffer, overwritten in place: every warpgroup holds its
//     tiles in registers until the layer's contraction ends, and a named
//     barrier of the consumers lets the epilogue write once all have read;
//   - the buffers are zeroed once, so halo rows, padded channels and the up
//     to Kc - K*S values the last rows read past their taps are 0, never
//     NaN; only valid rows and the C real channels are written afterwards.
//
// Work: nc consumer warpgroups, each `tpw` m64 tiles of the block's rows in
// one column group, and a producer warpgroup of which one warp works. It
// streams the stack's chunks, layer by layer, chunk by chunk, group by
// group, through a ring of 2-8 stages with one bulk copy each
// (cp.async.bulk, both planes at once), each signalling a `full` mbarrier;
// the warpgroups of a chunk's group release it on its `empty` mbarrier. The
// stages are a multiple of the groups, so a stage only ever holds one
// group's chunks and no consumer runs two phases ahead of its barrier (a
// parity wait cannot tell those apart). The ring runs across layers, so the
// producer loads the next layer's weights during an epilogue. For each of
// its tiles a consumer warpgroup issues the three products of each of a
// chunk's k8 steps into the partial set from A fragments already in
// registers, loads and splits the next tile's A fragments (its second tile
// of this chunk, or its first of the next) while they run, then folds.
// Bias and ELU run on the accumulators. The last layer goes from the buffer
// to `out` in coalesced stores.
//
// What this does about the limits of the mma.sync design it replaces:
//   1. the tensor cores' full rate: wgmma, where each warp issued 78
//      mma.sync m16n8k8 a k8 step;
//   2. B fetched and split once a block: one wgmma reads a k8 x N slice of a
//      plane once for 64 rows, where each warp loaded and split its own copy
//      for 32 rows; the split is the packer's;
//   3. the fold: N/2 FADDs a thread a tile every chunk, not 104 every k8 step;
//   4. no block-wide barrier a chunk: consumers wait on the chunk's own
//      mbarrier, only its readers release it, one thread issues the copies.
// Registers bound the block: a warpgroup holds an m64 x N tile of
// accumulators for each of its tiles, the partial set (N/2 a thread each)
// and a chunk's A fragments split for each tile (32 each). At N = 104 a
// block holds two consumer warpgroups and the producer's (168 registers a
// thread at entry, 240 for the consumers after setmaxnreg), two tiles each:
// two batch rows of L=100 a block; at N = 32 four of one tile, at N = 128
// two of one. At the bench's shape on the card above (cli/k1_variants.py):
// 0.34 ms launched alone; the A fragments loaded after the fold, not under
// the products, 0.39; one row a block, 0.46; four warpgroups of one tile
// each, 0.26, but their 112 registers leave no room for the partial set
// (no_fold's error); the ring's stages within 3 %. The wrapper windows
// longer rows
// (kernels/conv_stack.py: k1_plan, k1_max_rows).
// The register rule, the mbarrier, bulk-copy and wgmma helpers and the
// launcher's prelude (`prepare`) are hopper.cuh's, shared with K2 and K3;
// the ELU, the TF32 split and the TF32 products are this file's own.
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_STAGES = 8;      // weight ring
constexpr int CHUNK_K = 32;        // contraction rows a chunk: one 128-byte swizzle atom of f32
constexpr bool PREFETCH = true;    // a tile's A fragments load while the last tile's products run

// The block's layout; mirrors kernels/conv_stack.py::K1Plan field by field.
struct Plan {
  int L, Cin, C, K, num_layer, R, P, S, S0, N, ngroups, nc, tpw, stages, Kc, Kc0, rows_alloc,
      rows_alloc0;
};

__host__ __device__ constexpr size_t smem_bytes(const Plan& p) {
  return 1024 +                                              // alignment of the ring
         (size_t)p.stages * p.N * 256 +                      // weight ring: two planes a stage
         4 * ((size_t)p.rows_alloc * p.S + (size_t)p.rows_alloc0 * p.S0) +
         4 * (size_t)p.num_layer * p.ngroups * p.N +         // biases
         16 * (size_t)p.stages;                              // full and empty mbarriers
}

// the Pallas kernel's ELU (conv_stack.py:45-47), with the full expf; K2's and
// K3's `elu` (hopper.cuh) takes ex2.approx
__device__ __forceinline__ float elu_expf(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

// TF32 round to nearest, ties away from zero, on the bits: equal to
// cvt.rna.tf32.f32 for every finite value, with the low 13 bits 0 (the
// packer's split of the weights is the same integer add and mask)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// 3xTF32 split of one fragment register: a = big + small + O(2^-22 a)
__device__ __forceinline__ void split(uint32_t a, uint32_t& big, uint32_t& small) {
  big = tf32_rna(__uint_as_float(a));
  small = tf32_rna(__uint_as_float(a) - __uint_as_float(big));
}

// D (m64 x N f32, N/2 a thread) = A (m64 x k8 TF32, from registers: each
// warp's 16 rows as mma.m16n8k8's A fragment) x B (k8 x N TF32, K-major,
// descriptor) (+ D when scale_d), the instruction's operand list written
// out: one instruction for each width of kernels/conv_stack.py K1_WIDTHS
template <int N>
struct Mma;

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Mma<104> {
  static __device__ __forceinline__ void run(float (&d)[52], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <int N, int NCMAX, int TPW>
__global__ void __launch_bounds__((NCMAX + 1) * 128, 1)
conv_stack_f32_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                      const float* __restrict__ b0, const float* __restrict__ wr,
                      const float* __restrict__ br, float* __restrict__ out, int B,
                      const Plan p) {
  constexpr int INC = consumer_regs(NCMAX);
  static_assert(NCMAX * INC + PRODUCER_REGS <= 512, "a quarter of the register file");
  static_assert(INC >= (TPW + 1) * N / 2 + 32 * TPW + 16,
                "TPW tiles' accumulators, the partial set and TPW chunks' A fragments");
  constexpr int STAGE = N * 256;                 // bytes of one chunk: two planes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const int stages = p.stages;
  float* buf = reinterpret_cast<float*>(ring + (size_t)stages * STAGE);
  float* xbuf = buf + (size_t)p.rows_alloc * p.S;
  float* sbias = xbuf + (size_t)p.rows_alloc0 * p.S0;
  const int GN = p.ngroups * N;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sbias + p.num_layer * GN);
  const uint32_t full = saddr(bars), empty = saddr(bars + stages);   // 8 bytes a barrier
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffff, tid >> 5, 0);   // uniform in the warp
  const int nct = p.nc * 128;                    // consumer threads
  const int nch0 = cdiv(p.Kc0, CHUNK_K), nchr = cdiv(p.Kc, CHUNK_K);
  const int T0 = nch0 * p.ngroups;               // layer 0's chunks
  const int T = T0 + (p.num_layer - 1) * nchr * p.ngroups;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * (p.nc / p.ngroups));   // the warps of one column group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if-else, whose two paths never meet again: ptxas then holds each to
  // its setmaxnreg count
  if (warp >= 4 * p.nc) {
    // ---- producer warpgroup: its first warp copies chunk t of the stack
    // (both planes) into stage t % stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 4 * p.nc && lane == 0) {
      for (int t = 0; t < T; ++t) {
        const int s = t % stages;
        if (t >= stages) mbar_wait(empty + 8 * s, (t / stages - 1) & 1);
        const float* src = t < T0 ? w0 + (size_t)t * (STAGE / 4)
                                  : wr + (size_t)(t - T0) * (STAGE / 4);
        mbar_expect_tx(full + 8 * s, STAGE);
        bulk_copy(saddr(ring + s * STAGE), src, STAGE, full + 8 * s);
      }
    }
  } else {
    // ---- consumers
    if constexpr (INC > launch_regs(NCMAX))
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(INC));
    const int r0 = blockIdx.x * p.R;
    const int Rv = min(p.R, B - r0);             // batch rows this block holds
    const int pad = p.K / 2;
    // zero the activation buffer and x's: halos, padded channels, tails, absent rows
    {
      float4* z = reinterpret_cast<float4*>(buf);
      const int n = (p.rows_alloc * p.S + p.rows_alloc0 * p.S0) / 4;
      for (int i = tid; i < n; i += nct) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = tid; i < p.num_layer * GN; i += nct)
      sbias[i] = i < GN ? b0[i] : br[i - GN];
    consumers_sync(nct);
    // x's rows (28 bytes at Cin=7: scalar copies), eight loads in flight a thread
    {
      const int row = p.L * p.Cin, n = Rv * row;
      const float* xb = x + (size_t)r0 * row;
      for (int e0 = tid; e0 < n; e0 += 8 * nct) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * nct;
          v[u] = e < n ? xb[e] : 0.f;
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

    const int wg = warp >> 2;      // this warpgroup: m64 tiles tg*tpw + j, column group g
    const int tg = wg / p.ngroups, g = wg - tg * p.ngroups;
    const int m_first = tg * p.tpw * 64 + (warp & 3) * 16;   // this warp's first row
    const int rows = Rv * p.P - (p.K - 1);         // rows of the fold that hold a batch row
    float acc[TPW][N / 2], part[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) part[i] = 0.f;   // read by the first product, which scales it by 0
    bool live[TPW];                                // tile j holds a row of the block
#pragma unroll
    for (int j = 0; j < TPW; ++j) live[j] = j < p.tpw && (tg * p.tpw + j) * 64 < rows;
    uint32_t ab[TPW][4][4], as[TPW][4][4];         // tile j's A fragments of a chunk, big and small
    int t0 = 0;                                    // the layer's first chunk in the stack
    for (int layer = 0; layer < p.num_layer; ++layer) {
      const int Ss = layer ? p.S : p.S0, Kl = layer ? p.Kc : p.Kc0, nch = layer ? nchr : nch0;
      const float* src = layer ? buf : xbuf;
      // tile j's A fragments of chunk cc, split: ldmatrix rows m + lane%16 at
      // k + 4*(lane/16)
      auto load_a = [&](int j, int cc) {
        const uint32_t a0 = saddr(src + (size_t)(m_first + 64 * j + (lane & 15)) * Ss +
                                  cc * CHUNK_K + (lane >> 4) * 4);
        const int n = min(4, (Kl - cc * CHUNK_K) / 8);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (ks < n) {
            uint32_t r[4];
            ldsm_x4(a0 + 32 * ks, r);
#pragma unroll
            for (int q = 0; q < 4; ++q) split(r[q], ab[j][ks][q], as[j][ks][q]);
            fence_operands(ab[j][ks]);
            fence_operands(as[j][ks]);
          }
      };
      for (int c = 0; c < nch; ++c) {
        const int t = t0 + c * p.ngroups + g;
        const int s = t % stages;
        mbar_wait(full + 8 * s, (t / stages) & 1);
        const int nks = min(4, (Kl - c * CHUNK_K) / 8);   // k8 steps of the chunk
        // the big plane, then the small one N*128 bytes on
        const uint64_t db = desc_sw128(saddr(ring + s * STAGE)), ds = db + N * 128 / 16;
#pragma unroll
        for (int j = 0; j < TPW; ++j) {
          // a tile that holds no row of the block issues no product
          if (!live[j]) continue;
          if (!PREFETCH || (j == 0 && c == 0)) load_a(j, c);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            if (ks < nks) {
              Mma<N>::run(part, as[j][ks], db + 2 * ks, ks);    // from zero at the chunk's first
              Mma<N>::run(part, ab[j][ks], ds + 2 * ks, 1);
              Mma<N>::run(part, ab[j][ks], db + 2 * ks, 1);
            }
          wgmma_commit();
          // the next tile's A fragments (this chunk's second, or the next
          // chunk's first) load while these products run; with no second
          // tile, after them
          const bool next_tile = j + 1 < TPW && live[j + 1];
          if (PREFETCH && next_tile) load_a(j + 1, c);
          if (PREFETCH && j > 0 && c + 1 < nch) load_a(0, c + 1);
          wgmma_wait_all();      // the partial set is complete (and, at the last tile, the stage read)
          fence_operands(part);
#pragma unroll
          for (int i = 0; i < N / 2; ++i) acc[j][i] = c ? acc[j][i] + part[i] : part[i];   // the fold
          if (PREFETCH && j == 0 && !next_tile && c + 1 < nch) load_a(0, c + 1);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      t0 += nch * p.ngroups;
      // epilogue: bias and ELU on the accumulators, valid rows and the C real
      // channels only, in place once every warpgroup has read the buffer
      if (layer > 0) consumers_sync(nct);
      const float* bias = sbias + layer * GN + g * N;
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        if (j >= p.tpw) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m_first + 64 * j + (lane >> 2) + 8 * h;
          const int r = m / p.P, l = m - r * p.P;
          if (r >= Rv || l >= p.L) continue;
          float* drow = buf + (size_t)(m + pad) * p.S;
#pragma unroll
          for (int jn = 0; jn < N / 8; ++jn) {
            const int nl = jn * 8 + 2 * (lane & 3), n = g * N + nl;
            const float2 bn = *reinterpret_cast<const float2*>(bias + nl);
            const float v0 = elu_expf(acc[j][4 * jn + 2 * h] + bn.x);
            const float v1 = elu_expf(acc[j][4 * jn + 2 * h + 1] + bn.y);
            if (n + 1 < p.C)
              *reinterpret_cast<float2*>(drow + n) = make_float2(v0, v1);   // 8-byte aligned: S, n even
            else if (n < p.C)
              drow[n] = v0;
          }
        }
      }
      // the next layer (or the copy below) reads rows that other
      // warpgroups wrote
      consumers_sync(nct);
    }
    // the last layer's valid rows and C columns to `out`, where the block's
    // rows lie one after another: consecutive threads store consecutive
    // 16 bytes (single values where C is no multiple of 4)
    float* ob = out + (size_t)r0 * p.L * p.C;
    const int LC = p.L * p.C;
    if ((p.C & 3) == 0) {
      for (int u = tid; u < Rv * LC / 4; u += nct) {
        const int e = 4 * u, r = e / LC, l = (e - r * LC) / p.C, c = e - r * LC - l * p.C;
        *reinterpret_cast<float4*>(ob + e) =
            *reinterpret_cast<const float4*>(buf + (size_t)(r * p.P + pad + l) * p.S + c);
      }
    } else {
      for (int e = tid; e < Rv * LC; e += nct) {
        const int r = e / LC, l = (e - r * LC) / p.C, c = e - r * LC - l * p.C;
        ob[e] = buf[(size_t)(r * p.P + pad + l) * p.S + c];
      }
    }
  }
}

template <int N, int NCMAX, int TPW>
int launch(const void* x, const void* w0, const void* b0, const void* wr, const void* br,
           void* out, int B, const Plan& p, cudaStream_t stream) {
  constexpr auto kernel = conv_stack_f32_kernel<N, NCMAX, TPW>;
  if (p.tpw < 1 || p.tpw > TPW) return (int)cudaErrorInvalidValue;
  if (const int e = prepare<kernel, NCMAX>(p.nc)) return e;
  kernel<<<cdiv(B, p.R), (p.nc + 1) * 128, smem_bytes(p), stream>>>(
      (const float*)x, (const float*)w0, (const float*)b0, (const float*)wr, (const float*)br,
      (float*)out, B, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L, Cin) f32; w0 (ceil(Kc0/32), ngroups, 2, N*32) f32 chunks (big,
// small); b0 (ngroups*N) f32; wr (num_layer-1, ceil(Kc/32), ngroups, 2,
// N*32) f32 and br (num_layer-1, ngroups*N) f32, NULL when num_layer == 1;
// out (B, L, C) f32. All contiguous and 16-byte aligned, in the layout
// described above. `plan` holds the n_plan ints of struct Plan, from
// kernels/conv_stack.py::K1Plan. Launches ceil(B / R) blocks of nc consumer
// warpgroups and a producer warpgroup on `stream`; returns a CUDA error code
// (0 on success).
extern "C" int conv_stack_f32_launch(const void* x, const void* w0, const void* b0,
                                     const void* wr, const void* br, void* out,
                                     int B, const int* plan, int n_plan,
                                     void* stream) {
  Plan p;
  if (n_plan != (int)(sizeof(Plan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  memcpy(&p, plan, sizeof(p));
  if (p.S % 4 || p.S0 % 4 || p.R < 1 || p.C > p.S || p.ngroups < 1 || p.nc % p.ngroups ||
      p.C > p.ngroups * p.N || smem_bytes(p) > SMEM_LIMIT ||
      (p.num_layer > 1 && (wr == nullptr || br == nullptr)) ||
      64 * p.tpw * (p.nc / p.ngroups) < p.R * p.P - (p.K - 1) || p.Kc % 8 || p.Kc0 % 8 ||
      p.stages < 2 || p.stages > MAX_STAGES || p.stages % p.ngroups)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.N) {   // kernels/conv_stack.py K1_WIDTHS: N -> most consumer warpgroups, tiles each
    case 32: return launch<32, 4, 1>(x, w0, b0, wr, br, out, B, p, s);
    case 104: return launch<104, 2, 2>(x, w0, b0, wr, br, out, B, p, s);
    case 128: return launch<128, 2, 1>(x, w0, b0, wr, br, out, B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
