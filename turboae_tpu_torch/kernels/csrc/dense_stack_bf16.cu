// Fused DenseNet-style Conv1d + ELU stack in bf16 on Hopper's warpgroup
// tensor cores (sm_90a): DEC_LargeCNN's dense stacks in one launch a stack.
//
// Replaces no TPU kernel: the JAX package runs dense stacks through XLA's
// convolutions (turboae_tpu/models/decoders.py: `use_fused_conv and not
// dense`), and the port ran them as cuDNN convolutions with a running
// torch.cat (ops/conv1d.py:dense_stack_apply), whose layout copies,
// concatenations, bias adds and ELUs took five sixths of the stacks' device
// time. What it computes, per batch row b:
//   h_0 = x[b]                                              (L, Cin), bf16
//   out_i = bf16(ELU(sum_k [h_0, out_0, .., out_{i-1}][l + k - K/2] @ W_i[k] + b_i))
// with zero padding, bf16 operands, f32 accumulation, bias and ELU
// (exp(min(v,0)) - 1) in f32. Only the last layer is written to device
// memory.
//
// Bound: at DeepTurbo's shape (B=2000, L=100, Cin=7, C=100, K=5, 5 layers)
// a call does 2*B*L*K*C*sum_i(Cin + i*C) = 2.07e11 FLOP on ~44 MB of input,
// output and weights: ~4700 FLOP per byte, far above the H100's 295
// FLOP/byte bf16 ridge, so the tensor cores' rate bounds it: 0.209 ms at
// 989.4 TFLOP/s.
//
// Layout: K2's ring of weight chunks with one channel-blocked activation
// buffer, read by the tensor cores through descriptors on both operands.
//   - a block holds up to R batch rows of P = L+K-1 rows each (K/2 zero halo
//     rows on each side), one after another, in ONE buffer that holds every
//     channel of the stack: x in channels [0, Cin), a zero channel where Cin
//     is odd (Cinp = Cin rounded up to even), then out_i in [Cinp + i*Cs,
//     Cinp + i*Cs + C) (Cs = C rounded up to even, so every bf16 pair store
//     lies in one group and is 4-byte aligned). No concatenation, transpose,
//     memset or bias/ELU pass reaches device memory;
//   - the buffer is channel-blocked: channel c of row m at value (c/8)*GS +
//     8*m + c%8, GS = 8*R*P (the group stride, 16 bytes a row). Each 8-row by
//     8-channel piece is then one contiguous 128-byte core matrix of wgmma's
//     K-major layout without swizzle: 128 bytes between core matrices along
//     M (SBO), GS*2 bytes along K (LBO);
//   - layer i contracts, for each tap k, the buffer's rows m + k over its
//     own channels [0, Kr_i), Kr_i = Cinp + i*Cs rounded up to 16. The k16
//     steps run tap by tap, Kr_i/16 a tap, K*Kr_i/16 a layer (5,360
//     contraction rows a stack at DeepTurbo's shape against 5,175 exact):
//     step g of tap k reads A by a descriptor that starts at groups 2g, 2g+1
//     and row (the tile's first) + k, 16 bytes a row further for each tap.
//     K2's fold of K*S contiguous values would contract every layer over all
//     K*S values, twice this work;
//   - the channels a layer's rounding adds beyond its own have zero weights:
//     they read out_i's slot (zero, or out_i itself once written) or, past
//     the last written channel, a group that stays zero; all finite;
//   - M = Rv*P - (K-1) output rows a layer (Rv the block's rows) in m64
//     tiles, one a consumer warpgroup. The padded tiles' rows read on past
//     their group's R*P rows into the next group (finite values; their
//     results are never written), and past the last group into a zero tail
//     of 64*nc + K - 1 - R*P rows: at DeepTurbo's shape two rows a block, 52
//     groups (layer 4 rounds to 416 channels) of 208 rows and a tail of 52
//     rows, 52*208*16 + 832 = 173,888 bytes, beside a 4-stage ring of n104
//     chunks (53,248), the biases (2,080) and the barriers, 230,304 bytes in
//     all; M = 204 in four consumer warpgroups;
//   - no read-write race, by a consumer barrier before each epilogue: a
//     layer's epilogue writes out_i's slot, which the same layer's products
//     read (zero weights) where Kr_i runs into it, and the last layer's
//     epilogue writes its output over channels [0, Cs), which every layer
//     reads. Every thread fences its writes to the async proxy, which the
//     tensor cores read through, and the barrier after each epilogue makes
//     the next layer read what every warpgroup wrote. The last layer's valid
//     rows and C columns then go from the buffer to `out` in coalesced
//     8-byte stores;
//   - the weights of layer i are W_i'[16*j + q, n], k16 step j = tap*Kr_i/16
//     + g, buffer channel g*16 + q, = W_i[n, input channel of that buffer
//     channel, tap] (zero where the channel is a pad or >= the layer's own
//     Cinp + i*Cs, or n >= C), cut into chunks of 64 rows (4 steps; the
//     last chunk of a layer zero-filled) of N columns, each N*128 contiguous
//     bytes in wgmma's K-major 128-byte-swizzle layout: element (k, n) at
//     (n/8)*1024 + (n%8)*128 + ((k/8) ^ (n%8))*16 + (k%8)*2 bytes, packed by
//     the wrapper (kernels/conv_stack.py:pack_dense_bf16). A descriptor over
//     the chunk plus 32 bytes per k16 step reads it.
//
// Work: as K2. NC consumer warpgroups and a producer warpgroup of which one
// warp streams the stack's chunks, layer after layer, through a ring of up
// to 4 stages by bulk copies (cp.async.bulk) on `full` mbarriers. Consumers
// run wgmma.mma_async m64n104k16 with A and B by descriptor, always a
// chunk's four k16 steps as one committed group (past a layer's last step
// the chunk's weights are zero), and keep the next chunk's group in flight
// while they wait for the one before (wgmma.wait_group 1), then release
// that one's stage on its `empty` mbarrier; they wait for every group only
// before an epilogue, and a warpgroup whose tile holds no row waits for no
// chunk. setmaxnreg moves the producer's registers to the consumers. The
// producer loads the next layer's weights through the epilogues. The
// wrapper spreads the batch rows over whole rounds of blocks over the SMs
// (kernels/conv_stack.py:dense_plan), and windows the time axis where one
// row does not fit (run_windowed).
//
// What still keeps it from its bound (clock64 phases of a block of two rows
// at DeepTurbo's shape on an H100): the main loop takes ~1,350 SM clocks a
// chunk, ~84 a product where m64n104k16 needs 52 at the tensor peak, since
// each product of this narrow width carries a fixed cost beside its math
// (two products on the same operands cost ~54 each); the five epilogues,
// ~4,400 clocks each, hold 15 % of the block and stall the tensor cores
// between layers; staging x, 4 %; at two rows a block the m64 tiles hold
// 204 of 256 rows; each block streams the stack's 1.1 MB of chunks from L2
// again (without the products that alone takes ~0.25 ms a launch).
// The register rule, the mbarrier, bulk-copy and wgmma helpers, the ELU, the
// descriptors and the launcher's prelude (`prepare`) are hopper.cuh's,
// shared with K1 and K2.
#include <cuda_bf16.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_STAGES = 4;      // weight ring
constexpr int CHUNK_K = 64;        // contraction rows a chunk: one 128-byte swizzle atom

// The block's layout; mirrors kernels/conv_stack.py::DensePlan field by field.
struct Plan {
  int L, Cin, C, K, num_layer, R, G, P, GS, groups, Cinp, Cs, N, nc, stages, buf;
};

typedef __nv_bfloat16 bf16;

// contraction rows of one tap of layer i: its channels rounded up to 16
__host__ __device__ constexpr int tap_rows(const Plan& p, int i) {
  return cdiv(p.Cinp + i * p.Cs, 16) * 16;
}

// weight chunks of layer i
__host__ __device__ constexpr int layer_chunks(const Plan& p, int i) {
  return cdiv(p.K * tap_rows(p, i), CHUNK_K);
}

__host__ __device__ constexpr size_t smem_bytes(const Plan& p) {
  return 1024 +                                   // alignment of the ring
         (size_t)p.stages * p.N * 128 +           // weight ring
         2 * (size_t)p.buf +                      // the activation buffer
         4 * (size_t)p.num_layer * p.N +          // biases, f32
         16 * (size_t)p.stages;                   // full and empty mbarriers
}

// the buffer's value index of channel c of row m
__device__ __forceinline__ int at(const Plan& p, int m, int c) {
  return (c >> 3) * p.GS + 8 * m + (c & 7);
}

template <int N, int NCMAX>
__global__ void __launch_bounds__((NCMAX + 1) * 128, 1)
dense_stack_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                        const float* __restrict__ b0, const bf16* __restrict__ wr,
                        const float* __restrict__ br, bf16* __restrict__ out, int B,
                        const Plan p) {
  constexpr int INC = consumer_regs(NCMAX);
  static_assert(NCMAX * INC + PRODUCER_REGS <= 512, "a quarter of the register file");
  static_assert(INC >= N / 2 + 32, "accumulators and descriptors");
  constexpr int STAGE = N * 128;                 // bytes of one chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  const int stages = p.stages;
  bf16* buf = reinterpret_cast<bf16*>(ring + (size_t)stages * STAGE);
  float* sbias = reinterpret_cast<float*>(buf + p.buf);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sbias + p.num_layer * N);
  const uint32_t full = saddr(bars), empty = saddr(bars + stages);   // 8 bytes a barrier
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffff, tid >> 5, 0);   // uniform in the warp
  const int nct = p.nc * 128;                    // consumer threads
  const int T0 = layer_chunks(p, 0);
  int T = 0;                                     // the stack's chunks
  for (int i = 0; i < p.num_layer; ++i) T += layer_chunks(p, i);

  const int r0 = (int)((long long)blockIdx.x * B / gridDim.x);
  const int Rv = (int)((long long)(blockIdx.x + 1) * B / gridDim.x) - r0;   // rows of this block
  const int M = Rv * p.P - (p.K - 1);            // output rows of the block
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      // one arrival a warp of the warpgroups whose tile holds a row
      mbar_init(empty + 8 * s, 4 * min(p.nc, cdiv(M, 64)));
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
    const int pad = p.K / 2;
    // zero the buffer: halos, pads, the slots not yet written, absent rows,
    // the tail
    {
      uint4* z = reinterpret_cast<uint4*>(buf);
      for (int i = tid; i < p.buf / 8; i += nct) z[i] = make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < p.num_layer * N; i += nct) sbias[i] = i < N ? b0[i] : br[i - N];
    consumers_sync(nct);
    // x's rows into channels [0, Cin) (Cin may be odd: scalar copies), eight
    // loads in flight a thread
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
            buf[at(p, r * p.P + pad + l, ci)] = v[u];
          }
        }
      }
    }
    fence_proxy_async();                           // the tensor cores read what was written
    consumers_sync(nct);

    const int wg = warp >> 2;                      // this warpgroup's m64 tile
    const int m_warp = wg * 64 + (warp & 3) * 16;  // this warp's first row
    // a warpgroup whose tile holds no row of the block issues no product and
    // waits for no chunk
    const bool active = wg * 64 < M;
    // A of tap 0, k16 step 0: the tile's 64 rows of groups 0 and 1; a tap
    // moves it one row (16 bytes, one unit of the descriptor), a k16 step
    // two groups (GS/4 units)
    const uint64_t a_desc = desc_kmajor(saddr(buf + 8 * wg * 64), 2 * p.GS, 128);
    const int step_units = p.GS / 4;
    // the epilogue's two rows of this thread, m_warp + lane/4 and 8 on:
    // whether each is an output row, and its value offset in a group
    bool row_ok[2];
    int row_at[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_warp + (lane >> 2) + 8 * h, r = m / p.P, l = m - r * p.P;
      row_ok[h] = r < Rv && l < p.L;
      row_at[h] = 8 * (m + pad);
    }
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;   // read by the first product, which scales it by 0
    int t = 0;                                     // the stack's chunk counter
    for (int layer = 0; layer < p.num_layer; ++layer) {
      const int kpt = tap_rows(p, layer) / 16;     // k16 steps a tap
      const int nsteps = p.K * kpt, nch = cdiv(nsteps, 4);
      // every product of the layer, and the wait for them all, in one
      // branch: no path leaves it with a group still running (ptxas would
      // then serialize every product)
      if (active) {
        int held = -1;                             // the stage whose group may still run
        for (int c = 0; c < nch; ++c) {
          const int s = (t + c) % stages;
          mbar_wait(full + 8 * s, ((t + c) / stages) & 1);
          const int nks = min(4, nsteps - 4 * c);  // k16 steps of the chunk
          // step j = 4c + k reads tap j / kpt at k16 step j % kpt, and the
          // chunk's rows 16k on (32 bytes, 2 units). A chunk always runs four
          // products, one batch that ptxas chains without a warpgroup.arrive
          // between them: past a layer's last step (nks) the chunk's weights
          // are zero and A repeats the last step's rows, so they add exact
          // zeros. The descriptors are set before the fence for the same
          // reason
          const uint64_t d = desc_sw128(saddr(ring + s * STAGE));
          int tap = 4 * c / kpt, g = 4 * c - tap * kpt;
          uint64_t da[4], db[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            da[k] = a_desc + tap + g * step_units;
            db[k] = d + 2 * k;
            if (k + 1 < nks && ++g == kpt) {       // on to the next tap's row
              g = 0;
              ++tap;
            }
          }
          fence_operands(da);
          fence_operands(db);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) MmaBf16Smem<N>::run(acc, da[k], db[k], c | k);
          wgmma_commit();
          wgmma_wait<1>();                         // the chunk before has retired
          if (held >= 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * held);
          }
          held = s;
        }
        wgmma_wait<0>();
        fence_operands(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * held);
      }
      t += nch;
      // every warpgroup's products of this layer are done before any
      // epilogue writes channels that they read
      consumers_sync(nct);
      if (active) {
        // epilogue: bias, ELU and bf16 on the accumulators, valid rows only,
        // into out_i's slot (the last layer: channels [0, Cs)). This
        // thread's pairs start at channel c = col0 + 2 (lane % 4), even, so
        // each lies in one group, 4-byte aligned; the pair 8j channels on
        // is j groups (j GS values) on
        const float* bias = sbias + layer * N + 2 * (lane & 3);
        const int c = (layer == p.num_layer - 1 ? 0 : p.Cinp + layer * p.Cs) + 2 * (lane & 3);
        bf16* const base = buf + (c >> 3) * p.GS + (c & 7);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          if (8 * j + 2 * (lane & 3) >= p.Cs) continue;
          const float2 bn = *reinterpret_cast<const float2*>(bias + 8 * j);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row_ok[h])
              *reinterpret_cast<__nv_bfloat162*>(base + j * p.GS + row_at[h]) =
                  __floats2bfloat162_rn(elu(acc[4 * j + 2 * h] + bn.x),
                                        elu(acc[4 * j + 2 * h + 1] + bn.y));
        }
        fence_proxy_async();
      }
      // the next layer (or the copy below) reads rows that other
      // warpgroups wrote
      consumers_sync(nct);
    }
    // the last layer's valid rows and C columns to `out`, where the block's
    // rows lie one after another: consecutive threads store consecutive
    // 8 bytes (four channels of one group; single values where C is no
    // multiple of 4)
    bf16* ob = out + (size_t)r0 * p.L * p.C;
    const int LC = p.L * p.C;
    if ((p.C & 3) == 0) {
      for (int u = tid; u < Rv * LC / 4; u += nct) {
        const int e = 4 * u, r = e / LC, l = (e - r * LC) / p.C, c = e - r * LC - l * p.C;
        *reinterpret_cast<uint2*>(ob + e) =
            *reinterpret_cast<const uint2*>(buf + at(p, r * p.P + pad + l, c));
      }
    } else {
      for (int e = tid; e < Rv * LC; e += nct) {
        const int r = e / LC, l = (e - r * LC) / p.C, c = e - r * LC - l * p.C;
        ob[e] = buf[at(p, r * p.P + pad + l, c)];
      }
    }
  }
}

template <int N, int NCMAX>
int launch(const void* x, const void* w0, const void* b0, const void* wr, const void* br,
           void* out, int B, const Plan& p, cudaStream_t stream) {
  constexpr auto kernel = dense_stack_bf16_kernel<N, NCMAX>;
  if (const int e = prepare<kernel, NCMAX>(p.nc)) return e;
  kernel<<<p.G, (p.nc + 1) * 128, smem_bytes(p), stream>>>(
      (const bf16*)x, (const bf16*)w0, (const float*)b0, (const bf16*)wr, (const float*)br,
      (bf16*)out, B, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L, Cin) bf16; w0 (layer_chunks(0), N*64) bf16 chunks and b0 (N,) f32
// of layer 0; wr (sum of layer_chunks(i) for i >= 1, N*64) bf16 and br
// (num_layer-1, N) f32 of the other layers, NULL when num_layer == 1; out
// (B, L, C) bf16. All contiguous and 16-byte aligned, in the layout
// described above. `plan` holds the n_plan ints of struct Plan, from
// kernels/conv_stack.py::DensePlan. Launches G blocks of nc consumer
// warpgroups and a producer warpgroup on `stream`, block i taking batch rows
// [i*B/G, (i+1)*B/G); returns a CUDA error code (0 on success).
extern "C" int dense_stack_bf16_launch(const void* x, const void* w0, const void* b0,
                                       const void* wr, const void* br, void* out,
                                       int B, const int* plan, int n_plan,
                                       void* stream) {
  Plan p;
  if (n_plan != (int)(sizeof(Plan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  memcpy(&p, plan, sizeof(p));
  // rows a group; the rows the padded tiles read past the last group's
  const int rows = p.GS / 8, past = 64 * p.nc + p.K - 1 - rows;
  if (p.num_layer < 1 || p.GS % 8 || rows < p.R * p.P || rows >= (1 << 14) || p.Cinp % 2 || p.Cs % 2 ||
      p.Cinp < p.Cin || p.Cs < p.C || p.Cs > p.N || 8 * p.groups < p.Cs ||
      8 * p.groups < tap_rows(p, p.num_layer - 1) || p.P != p.L + p.K - 1 || p.buf % 8 ||
      p.buf < p.groups * p.GS + 8 * (past > 0 ? past : 0) || p.G < 1 || p.G > B ||
      (B + p.G - 1) / p.G > p.R || smem_bytes(p) > SMEM_LIMIT ||
      (p.num_layer > 1 && (wr == nullptr || br == nullptr)) ||
      p.nc * 64 < p.R * p.P - (p.K - 1) || p.stages < 2 || p.stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // kernels/conv_stack.py DENSE_N, DENSE_NC: the one width and its most
  // consumer warpgroups
  if (p.N != 104) return (int)cudaErrorInvalidValue;
  return launch<104, 4>(x, w0, b0, wr, br, out, B, p, s);
}
