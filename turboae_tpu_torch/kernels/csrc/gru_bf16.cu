// One bidirectional GRU layer in bf16 on Hopper's warpgroup tensor cores
// (sm_90a): all L steps of both directions in one launch.
//
// Replaces no TPU kernel: the JAX package runs the recurrence as a lax.scan
// (turboae_tpu/ops/gru.py:_gru_scan), and the port ran it on the card as
// cuDNN's RNN (ops/gru.py:_cudnn_layer), which at B=2000 launches a GEMM and
// a gate kernel for every step and direction, 400 launches a layer, each
// step reading W_hh and h back from device memory. What it computes, for
// each batch row and direction (the reverse one walking t = L-1 .. 0):
//   r = sigmoid(x_t W_ir' + h W_hr' + (b_ir + b_hr))
//   z = sigmoid(x_t W_iz' + h W_hz' + (b_iz + b_hz))
//   n = tanh(x_t W_in' + b_in + r (h W_hn' + b_hn))
//   h = n + z (h - n)
// with x_t, h and the weights rounded to bf16 for the products, f32
// accumulation (r's and z's two products in one accumulator), and the bias
// adds, the gate math and the carried h in f32: sigmoid(v) = 1 / (1 +
// e^-v) and tanh(v) = 1 - 2 / (1 + e^2v), e by __expf, its argument held
// below 80 (e^80 < 2^126, where the approximate division stays within 2
// ulp; sigmoid(-80) is 2e-35). out[b, t, d H + j] is h_j after step t, in
// bf16 (a stack's inner layers, which the next layer reads as they are) or
// f32 (its last). Only the bf16 copy of h feeds the next step's product,
// where cuDNN's bf16 RNN carries h itself in bf16.
//
// Bound: at the TurboAE-RNN decoder's shapes (B=2000, L=100, H=100) a layer
// does 2 * 2 B L (In 3H + H 3H) FLOP: 24.8 GFLOP at In = 7, 72 GFLOP at
// In = 200 (25 and 73 us at 989.4 TFLOP/s); its bytes (x, weights, out)
// are a few tens of MB. Neither bounds it: each of the L steps of a row
// needs the step before, so a layer is L dependent rounds of an (m64 x 112)
// x (112 x 312) product, gate math and a barrier on each SM that holds
// rows.
//
// Layout: a block holds the batch rows [32 bx, 32 bx + 32) of direction by
// as the rows m of one m64 tile with m % 16 < 8 (row m0 = 16w + lane/4 of
// warp w), so that the gate math spreads over 126 SMs at B=2000 and every
// warp has rows: the tile's rows m0 + 8 are zeros and junk, half the
// products' work. Two warpgroups split each gate's 104 padded columns
// (hidden units) as n56 + n48, with four f32 accumulators each (r, z, n's
// x part, n's h part) and the f32 carry of their units in registers.
//   - shared memory: W_hh' (112 x 312) and W_ih' (16 KX x 312; KX = 1 for
//     In <= 16, 13 for In <= 208) of the direction, loaded once by bulk
//     copies, both K-major without swizzle: element (k, n) at ((n/8) * Kp/8
//     + k/8) * 128 + (n%8) * 16 + (k%8) * 2 bytes (Kp = 112 or 16 KX), so a
//     gate's columns from C0 are one descriptor (start (g 104 + C0)/8
//     core-matrix rows on, 128 bytes between k-neighbours, Kp * 16 between
//     8-column groups), packed by the wrapper (kernels/gru.py:pack_gru_bf16);
//     the biases, f32 (4 x 104: b_ir + b_hr, b_iz + b_hz, b_in, b_hn, zero
//     past H); h's bf16 copy (64 x 112), the h products' A by descriptor:
//     element (m, k) at ((k/8) * 8 + m/8) * 128 + (m%8) * 16 + (k%8) * 2;
//     x's stage, the x products' A by descriptor: the 32 rows alone, 8
//     channels of row r at (k/8) * 512 + (r/8) * 128 + (r%8) * 16, read with
//     64 bytes between 8-row groups, so that the tile's rows m0 + 8 overlap
//     the others (finite values that reach only junk accumulator rows). At
//     In = 200: 69,888 + 129,792 + 1,664 + 14,336 + 13,376 bytes;
//   - x's next step goes into the stage by cp.async (16 bytes a thread, a
//     row's bytes to consecutive threads) during the gate math.
// A step: wgmma m64nNk16, A and B by descriptor, over x (3 KX products) and
// h (21), one committed group; its wait; a barrier (every product has read
// h's copy and the stage); the next step's x into the stage; the gate math
// on the accumulators (branch-free: a unit past H has zero weights and
// biases and stays at 0), the carry, h's bf16 copy and the step's output to
// device memory, where a thread's four units of a pair of column groups
// are contiguous (the column order of kernels/gru.py:_units), one vector
// store, and the biases stay in registers; the stage's wait, a proxy fence
// and a barrier.
//
// What holds it (clock64 phases of block 0 at the cell's shapes on an H100
// at 1980 MHz, PERF.md §6): ~4,020 SM clocks a step at In = 7 (products
// ~1,480, the tensor cores' rate for 48 products of n56/n48; gate math and
// the barriers ~2,500, of which the sigmoids' and tanh's MUFU work ~700),
// ~6,880 at In = 200 (products ~3,520); the tile's junk rows double the
// products; the 56/48 split leaves the n48 warpgroup waiting at the first
// barrier.
#include <cuda_bf16.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int NH = 104;             // a gate's columns: H padded to 13 groups of 8
constexpr int NCOL = 3 * NH;        // the gates r, z, n side by side
constexpr int KH = 7;               // k16 steps of the h products (H padded to 112)
constexpr int TILE = 64;            // rows of a wgmma tile
constexpr int ROWS = 32;            // batch rows a block: the tile's rows m with m % 16 < 8
constexpr int THREADS = 256;        // two warpgroups
constexpr int CORE = 128;           // bytes of a core matrix: 8 rows of 16 bytes
constexpr int WHH_BYTES = NCOL / 8 * 2 * KH * CORE;
constexpr int BIAS_BYTES = 4 * NH * 4;
constexpr int HBUF = 2 * KH * (TILE / 8) * CORE;   // h's bf16 copy, 64 x 112
constexpr int XKB = ROWS / 8 * CORE;               // x's stage: bytes of 8 channels
constexpr int SLACK = 64;           // read past the stage's end by its last rows
constexpr int COPY = 32768;         // bytes a bulk copy

// The launch; mirrors kernels/gru.py::GruPlan field by field.
struct Plan {
  int L, In, H, KX, G, out_f32;
};

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int wih_bytes(int kx) { return NCOL / 8 * 2 * kx * CORE; }
__host__ __device__ constexpr int weight_bytes(int kx) { return WHH_BYTES + wih_bytes(kx); }
__host__ __device__ constexpr int stage_bytes(int kx) { return 2 * kx * XKB + SLACK; }
__host__ __device__ constexpr int smem_bytes(int kx) {
  return weight_bytes(kx) + BIAS_BYTES + HBUF + stage_bytes(kx) + 16;   // and the mbarrier
}

__device__ __forceinline__ float sigm(float v) {
  return __fdividef(1.f, 1.f + __expf(fminf(-v, 80.f)));
}

__device__ __forceinline__ float tanh_e(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(fminf(2.f * v, 80.f)));
}

// h after a step from the step's four accumulators, the biases and h
// before. A unit past H has zero weights and biases, so it stays at 0:
// r = z = 1/2, n = 0
__device__ __forceinline__ float gru_step(float ar, float az, float ai, float ah, float br,
                                          float bz, float bi, float bn, float h) {
  const float r = sigm(ar + br), z = sigm(az + bz);
  const float n = tanh_e(ai + bi + r * (ah + bn));
  return n + z * (h - n);
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes from device memory into shared memory, zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x's step t into the stage, the block's 32 rows: 16 bytes (8 channels) of
// row r at stage byte (k/8) * 512 + (r/8) * 128 + (r%8) * 16, a core matrix
// for each 8 rows; consecutive threads read consecutive bytes of a row
__device__ __forceinline__ void stage_x(uint32_t stage, const bf16* x, int B, int L, int Xs,
                                        int t) {
  const int nkb = Xs / 8;
  for (int i = threadIdx.x; i < ROWS * nkb; i += THREADS) {
    const int r = i / nkb, kb = i - r * nkb, b = blockIdx.x * ROWS + r;
    const bool valid = b < B;
    cp_async16(stage + kb * XKB + (r / 8) * CORE + (r % 8) * 16,
               valid ? x + ((size_t)b * L + t) * Xs + 8 * kb : x, valid);
  }
}

// One warpgroup's L steps: its columns [C0, C0 + N) of each gate.
// Column 8j + 2q + e of the warpgroup (group j, lane q of a quad) holds
// hidden unit C0 + 16 (j/2) + 4q + 2 (j%2) + e, or C0 + 8j + 2q + e in a
// last group without a pair (kernels/gru.py:_units), so that a thread's
// units of a pair of groups are four contiguous ones: one vector store of
// the output.
template <int KX, int N, int C0>
__device__ __forceinline__ void recur(const bf16* __restrict__ x, void* __restrict__ out, int B,
                                      const Plan& p, uint32_t whh, uint32_t wih,
                                      const float* bias, unsigned char* hb, uint32_t stage,
                                      int dir) {
  constexpr int NA = N / 2;                      // accumulators a gate a thread
  constexpr int NG = N / 8, NP = NG / 2;         // groups of 8 columns; pairs of them
  const int tid = threadIdx.x, lane = tid & 31, q = lane & 3, w = tid >> 5 & 3;
  // this thread's tile row m0 and its batch row
  const int m0 = 16 * w + (lane >> 2);
  const int b0 = blockIdx.x * ROWS + 8 * w + (lane >> 2);
  const bool ok = b0 < B;
  const int L = p.L, H = p.H, Xs = (p.In + 7) & ~7;
  const bool vec = (H & 3) == 0;                 // 4 units of a pair aligned in out
  // gate g's columns from C0, k16 step 0; a k16 step is two core matrices
  // on (256 bytes, 16 units) in the weights, 2 * 8 in h (2048, 128 units),
  // 2 * 4 in x's stage (1024, 64 units), whose rows m0 + 8 (stride 64
  // bytes) overlap its others and reach only the accumulators' rows m0 + 8
  uint64_t dhh[3], dih[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    dhh[g] = desc_kmajor(whh + (g * NH + C0) / 8 * (2 * KH * CORE), CORE, 2 * KH * CORE);
    dih[g] = desc_kmajor(wih + (g * NH + C0) / 8 * (2 * KX * CORE), CORE, 2 * KX * CORE);
  }
  const uint64_t dh = desc_kmajor(saddr(hb), TILE / 8 * CORE, CORE);
  const uint64_t dx = desc_kmajor(stage, XKB, CORE / 2);
  float ar[NA], az[NA], ai[NA], ah[NA], hc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) ar[i] = az[i] = ai[i] = ah[i] = hc[i] = 0.f;
  const int step = dir ? -1 : 1;
  int t = dir ? L - 1 : 0;
  stage_x(stage, x, B, L, Xs, t);
  cp_async_wait_all();
  fence_proxy_async();
  consumers_sync(THREADS);
  const size_t ostride = (size_t)L * 2 * H;      // output values a batch row
  // row m0 of h's copy (column c at ((c/8) * 8 + m0/8) * 128 + (m0%8) * 16 +
  // (c%8) * 2 bytes); its rows m0 + 8 stay zero
  unsigned char* const hn = hb + (m0 / 8) * CORE + (m0 % 8) * 16;
  // this thread's biases, the same at every step: a pair's [gate][unit],
  // then the last group's
  float bp[NP][16], bl[8];
#pragma unroll
  for (int j2 = 0; j2 < NP; ++j2)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(bias + g * NH + C0 + 16 * j2 + 4 * q);
      bp[j2][4 * g] = v.x;
      bp[j2][4 * g + 1] = v.y;
      bp[j2][4 * g + 2] = v.z;
      bp[j2][4 * g + 3] = v.w;
    }
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float2 v = *reinterpret_cast<const float2*>(bias + g * NH + C0 + 8 * (NG - 1) + 2 * q);
    bl[2 * g] = v.x;
    bl[2 * g + 1] = v.y;
  }
  for (int it = 0; it < L; ++it) {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KX; ++s) {
      MmaBf16Smem<N>::run(ar, dx + 64 * s, dih[0] + 16 * s, s);
      MmaBf16Smem<N>::run(az, dx + 64 * s, dih[1] + 16 * s, s);
      MmaBf16Smem<N>::run(ai, dx + 64 * s, dih[2] + 16 * s, s);
    }
#pragma unroll
    for (int s = 0; s < KH; ++s) {
      MmaBf16Smem<N>::run(ar, dh + 128 * s, dhh[0] + 16 * s, 1);
      MmaBf16Smem<N>::run(az, dh + 128 * s, dhh[1] + 16 * s, 1);
      MmaBf16Smem<N>::run(ah, dh + 128 * s, dhh[2] + 16 * s, s);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(ar);
    fence_operands(az);
    fence_operands(ai);
    fence_operands(ah);
    // every product of the step has read h and the stage
    consumers_sync(THREADS);
    const int tn = t + step;
    if (it + 1 < L) stage_x(stage, x, B, L, Xs, tn);
    // the gate math of row m0, h's bf16 copy, the output
    const size_t o = (size_t)b0 * ostride + (size_t)t * 2 * H + dir * H;
#pragma unroll
    for (int j2 = 0; j2 < NP; ++j2) {
      const int u = C0 + 16 * j2 + 4 * q;        // the first of this thread's four units
      const float* bv = bp[j2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * j2 + (e & 1) + 4 * (e >> 1);   // group 2 j2 + e/2, column e%2
        hc[i] = gru_step(ar[i], az[i], ai[i], ah[i], bv[e], bv[4 + e], bv[8 + e], bv[12 + e],
                         hc[i]);
      }
      const int i = 8 * j2;
      const uint2 hv = make_uint2(bf16x2(hc[i], hc[i + 1]), bf16x2(hc[i + 4], hc[i + 5]));
      const int c = C0 + 16 * j2 + 2 * q;        // column of group 2 j2
      *reinterpret_cast<uint32_t*>(hn + (c / 8) * (TILE / 8) * CORE + (c % 8) * 2) = hv.x;
      *reinterpret_cast<uint32_t*>(hn + (c / 8 + 1) * (TILE / 8) * CORE + (c % 8) * 2) = hv.y;
      if (!ok || u >= H) continue;
      const float v[4] = {hc[i], hc[i + 1], hc[i + 4], hc[i + 5]};
      if (p.out_f32) {
        float* of = static_cast<float*>(out) + o + u;
        if (vec && u + 3 < H) {
          *reinterpret_cast<float4*>(of) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (u + e < H) of[e] = v[e];
        }
      } else {
        bf16* ob = static_cast<bf16*>(out) + o + u;
        if (vec && u + 3 < H) {
          *reinterpret_cast<uint2*>(ob) = hv;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (u + e < H) ob[e] = __float2bfloat16_rn(v[e]);
        }
      }
    }
    if constexpr (NG % 2 == 1) {
      // the last group, without a pair: units C0 + 8j + 2q + {0, 1}
      constexpr int j = NG - 1;
      const int u = C0 + 8 * j + 2 * q, i = 4 * j;
      const float* bv = bl;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        hc[i + e] = gru_step(ar[i + e], az[i + e], ai[i + e], ah[i + e], bv[e], bv[2 + e],
                             bv[4 + e], bv[6 + e], hc[i + e]);
      const uint32_t hv = bf16x2(hc[i], hc[i + 1]);
      *reinterpret_cast<uint32_t*>(hn + (u / 8) * (TILE / 8) * CORE + (u % 8) * 2) = hv;
      if (ok && u < H) {
        const bool pair = (H & 1) == 0;
        if (p.out_f32) {
          float* of = static_cast<float*>(out) + o + u;
          if (pair) {
            *reinterpret_cast<float2*>(of) = make_float2(hc[i], hc[i + 1]);
          } else {
            of[0] = hc[i];
            if (u + 1 < H) of[1] = hc[i + 1];
          }
        } else {
          bf16* ob = static_cast<bf16*>(out) + o + u;
          if (pair) {
            *reinterpret_cast<uint32_t*>(ob) = hv;
          } else {
            ob[0] = __float2bfloat16_rn(hc[i]);
            if (u + 1 < H) ob[1] = __float2bfloat16_rn(hc[i + 1]);
          }
        }
      }
    }
    cp_async_wait_all();
    fence_proxy_async();                         // the tensor cores read what was written
    consumers_sync(THREADS);
    t = tn;
  }
}

template <int KX>
__global__ void __launch_bounds__(THREADS, 1)
gru_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ b, void* __restrict__ out, int B, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dir = blockIdx.y, tid = threadIdx.x;
  constexpr int WB = weight_bytes(KX);
  const uint32_t whh = saddr(smem), wih = whh + WHH_BYTES;
  float* bias = reinterpret_cast<float*>(smem + WB);
  unsigned char* hb = smem + WB + BIAS_BYTES;
  unsigned char* stage = hb + HBUF;
  const uint32_t full = saddr(stage + stage_bytes(KX));
  if (tid == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // the direction's weights and biases, once
    mbar_expect_tx(full, WB + BIAS_BYTES);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(w) + (size_t)dir * WB;
    for (int off = 0; off < WB; off += COPY) bulk_copy(whh + off, src + off, min(COPY, WB - off), full);
    bulk_copy(saddr(bias), b + dir * 4 * NH, BIAS_BYTES, full);
  }
  // h's copy and x's stage start at zero: h_0, the units past H, the rows
  // that hold no batch row, the channels past x's
  for (int i = tid; i < (HBUF + stage_bytes(KX)) / 16; i += THREADS)
    reinterpret_cast<uint4*>(hb)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  mbar_wait(full, 0);
  __syncthreads();
  if (tid < 128)
    recur<KX, 56, 0>(x, out, B, p, whh, wih, bias, hb, saddr(stage), dir);
  else
    recur<KX, 48, 56>(x, out, B, p, whh, wih, bias, hb, saddr(stage), dir);
}

template <int KX>
int launch(const void* x, const void* w, const void* b, void* out, int B, const Plan& p,
           cudaStream_t stream) {
  constexpr auto kernel = gru_bf16_kernel<KX>;
  // once a device (each a host call): the shared memory above 48 KB
  static bool ready[64];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(KX));
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  kernel<<<dim3(p.G, 2), THREADS, smem_bytes(KX), stream>>>(
      (const bf16*)x, (const bf16*)w, (const float*)b, out, B, p);
  return (int)cudaGetLastError();
}

static_assert(smem_bytes(13) <= SMEM_LIMIT, "the widest input's layout fits a block");

}  // namespace

// x (B, L, Xs) bf16, Xs = In rounded up to 8, zero past In; w (2,
// weight_bytes(KX) / 2) bf16, each direction's W_hh' then W_ih' in the
// layout described above; b (2, 4, 104) f32; out (B, L, 2H), f32 where
// plan.out_f32 else bf16. All contiguous, x, w and b 16-byte aligned. The
// two pointers between b and out are unused (the launchers' six). `plan`
// holds the n_plan ints of struct Plan, from kernels/gru.py::GruPlan.
// Launches G x 2 blocks of two warpgroups on `stream`, block (i, d) taking
// batch rows [32 i, 32 i + 32) in direction d; returns a CUDA error code (0
// on success).
extern "C" int gru_bf16_launch(const void* x, const void* w, const void* b, const void*,
                               const void*, void* out, int B, const int* plan, int n_plan,
                               void* stream) {
  Plan p;
  if (n_plan != (int)(sizeof(Plan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  memcpy(&p, plan, sizeof(p));
  if (p.L < 1 || p.H < 1 || p.H > NH || p.In < 1 || p.In > 16 * p.KX || B < 1 ||
      p.G != cdiv(B, ROWS) || p.G > 65535 || (p.out_f32 != 0 && p.out_f32 != 1) ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)b) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // kernels/gru.py GRU_KX: a narrow input in one k16 step, a wide one in 13
  if (p.KX == 1) return launch<1>(x, w, b, out, B, p, s);
  if (p.KX == 13) return launch<13>(x, w, b, out, B, p, s);
  return (int)cudaErrorInvalidValue;
}
