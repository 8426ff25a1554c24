// RBF kernel block on Hopper's tensor cores:
//   out[i, j] = var * exp(-max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0) / (2 ls^2)).
//
// Replaces the Pallas TPU kernel ital_tpu/ops/pallas_rbf.py::rbf_kernel_pallas
// (pallas_rbf.py:54, pl.pallas_call at pallas_rbf.py:90) for the calls with a
// wide feature axis or a large output; the FMA tile kernel beside it
// (rbf_tile.cu) keeps the narrow and unaligned ones.
// ital_tpu_torch/ops/rbf_hopper.py picks the route from shape, dtype and
// alignment before the launch.
//
// What bounds it on an H100.  The EMOC block (25000, 2048, 512) is 52.4 GFLOP
// of dot products for 51 MB read and 205 MB written: compute-bound.  On the
// CUDA cores (67 TFLOP/s f32) the FMA kernel needs 2.3 ms; the tensor cores
// run TF32 at 495 TFLOP/s, but TF32 keeps 10 mantissa bits, and with dot
// products in the thousands (ReLU features, D = 512) that moves d^2 by ~1,
// far above the 1e-5 x var bound at ls = 50.  So f32 takes 3xTF32: each
// operand is split as big = rna_tf32(x), small = rna_tf32(x - big), and the
// block accumulates big.big + big.small + small.big in f32 (small.small
// dropped): 157 GFLOP of tensor work, ~0.32 ms at the peak, plus the 205 MB
// store (~0.06 ms).  A bf16 corpus takes one bf16 pass (products of bf16
// values are exact in f32).  The gp_fit cross-kernel (64, 25000, 512) does
// 1.6 GFLOP (4.9 as 3xTF32) on the 51 MB corpus: at 3.35 TB/s the read alone
// takes ~15 us, so its tile is a 64-row slab that reads the corpus once and
// wastes no rows; there the split pass over every staged value, not the
// tensor cores, sets the pace.
//
// What the design does about it.  One producer warp keeps a ring of
// STAGES shared-memory stages full with TMA loads (cp.async.bulk.tensor, 128 B
// swizzle, a 128-byte chunk of the feature axis: 32 f32 or 64 bf16 per row),
// each stage guarded by a full and an empty mbarrier; its warpgroup gives its
// registers back with setmaxnreg.  Two consumer warpgroups own the output
// tile (128 x 128 as two 64 x 128 halves, or a 64 x 128 slab as two
// 64 x 64 halves).  They issue wgmma.mma_async (m64nNk8 tf32, m64nNk16 bf16)
// from shared memory on one stage and, while the tensor cores work on it,
// ready the next: for f32 they split it in place (big over the raw values,
// small into a second buffer of the same layout).  Each stage's big.big
// products go to a fresh accumulator that is then added to the f32 total with
// ordinary rounding (see "Accumulation" below).  Norms come from a2/b2 where
// the caller gives them; otherwise the split pass sums them in f32 from the
// staged values (not the tf32 parts), so a bf16 corpus keeps its
// self-distances at 0 (the rule of pallas_rbf.py:42-49).  The epilogue
// clamps, applies exp and stores f32 from the accumulator registers, masked
// at the edges; TMA fills out-of-bounds boxes with zeros, so ragged M, N and D
// need no padding.  ls and var come from device memory or by value, never
// from a host sync.  The grid walks the smaller operand fastest, so the larger
// one streams from device memory once while the smaller stays in L2.  No
// cuBLAS, no CUTLASS GEMM: the PTX below is the whole product.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWG = 128;        // threads per warpgroup
constexpr int kBN = 128;        // output tile width (the wgmma N)
constexpr int kRowBytes = 128;  // one staged row: a 128-byte chunk of the feature axis
constexpr int kKSteps = 4;      // wgmma k-steps per staged chunk (32 bytes each)

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kBK = 32;        // features per staged chunk
  static constexpr bool kSplit = true;  // 3xTF32
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kBK = 64;
  static constexpr bool kSplit = false;
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// The output tile is WGM x WGN warpgroup tiles of 64 rows by kBN / WGN columns.
template <typename T, int WGM, int WGN, int STAGES>
struct Layout {
  static constexpr int kBM = 64 * WGM;
  static constexpr int kTmaBytes = (kBM + kBN) * kRowBytes;  // raw A and B tiles of a stage
  static constexpr int kStageBytes = kTmaBytes * (Elem<T>::kSplit ? 2 : 1);
  static constexpr int kSmemBytes =
      1024 /* alignment slack */ + STAGES * kStageBytes + 2 * STAGES * 8 + (kBM + kBN) * 4;
};

// ---- PTX wrappers --------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D TMA box (inner coordinate first) into shared memory; completion is
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows under the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), LBO unused (1).
// The tile must start on a 1024-byte boundary; a k-step within the 128-byte
// row advances the start address by 32 bytes (+2 in the 16-byte field).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across an in-flight wgmma.
template <int K>
__device__ __forceinline__ void fence_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ITAL_WGMMA_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
#define ITAL_WGMMA_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
#define ITAL_WGMMA_OPS_LO(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),  \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define ITAL_WGMMA_OPS_HI(d) \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]),  \
      "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),  \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]),  \
      "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// wgmma.mma_async with both operands from shared memory and an f32
// accumulator of N columns (N / 2 registers a thread):
//   tf32: d[64xN] = A[64x8] . B[Nx8]^T (+ d where scale_d);
//   bf16: d[64xN] = A[64x16] . B[Nx16]^T (+ d where scale_d), both K-major.
template <int N> struct Wgmma;
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void tf32(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " ITAL_WGMMA_D64
        "%64, %65, p, 1, 1;\n}\n"
        : ITAL_WGMMA_OPS_LO(d), ITAL_WGMMA_OPS_HI(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ITAL_WGMMA_D64
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : ITAL_WGMMA_OPS_LO(d), ITAL_WGMMA_OPS_HI(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void tf32(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ITAL_WGMMA_D32
        "%32, %33, p, 1, 1;\n}\n"
        : ITAL_WGMMA_OPS_LO(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void bf16(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ITAL_WGMMA_D32
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : ITAL_WGMMA_OPS_LO(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// cvt.rna.tf32.f32 on finite values (keep 10 mantissa bits, round to nearest,
// ties away from zero), in two integer ops: they issue at a higher rate than
// the conversion, and the split pass runs twice per staged value.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// Split the 4 f32 values of one 16-byte chunk in place (big) and into `small`;
// returns the sum of their squares (of the staged f32 values).
__device__ __forceinline__ float split_chunk(uint8_t* raw, uint8_t* small) {
  const float4 v = *reinterpret_cast<const float4*>(raw);
  float4 bg, sm;
  bg.x = tf32_rna(v.x); sm.x = tf32_rna(v.x - bg.x);
  bg.y = tf32_rna(v.y); sm.y = tf32_rna(v.y - bg.y);
  bg.z = tf32_rna(v.z); sm.z = tf32_rna(v.z - bg.z);
  bg.w = tf32_rna(v.w); sm.w = tf32_rna(v.w - bg.w);
  *reinterpret_cast<float4*>(raw) = bg;
  *reinterpret_cast<float4*>(small) = sm;
  return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}

// Sum of squares of one 16-byte chunk of 8 bf16 values, in f32.
__device__ __forceinline__ float sq_chunk_bf16(const uint8_t* raw) {
  const uint4 u = *reinterpret_cast<const uint4*>(raw);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    s = fmaf(f.x, f.x, s);
    s = fmaf(f.y, f.y, s);
  }
  return s;
}

__device__ __forceinline__ float row_sum8(float v) {  // over the 8 lanes that share a row
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// ---- the kernel ----------------------------------------------------------------------
//
// Warpgroups 0..NWG-1 consume: warpgroup wg owns the tile's rows
// 64 (wg / WGN) + [0, 64) and columns WN (wg % WGN) + [0, WN).  Warpgroup NWG
// produces.  Stage s holds [A raw | B raw | A small | B small] (the small
// halves for f32 only), each tile 128-byte rows from a 1024-byte boundary.
// The staged-chunk passes give thread t the 16-byte chunk t % 8 of a fixed
// set of rows, so its norm partials need one reduction over 8 lanes at the
// end.
//
// Accumulation.  The tensor cores add each k-step's products to the
// accumulator without rounding to nearest: measured on the card, one f32
// accumulator over all of D = 512 moved the (25000, 2048) block by up to
// 7.5e-5 x var (ls 50, dot products of thousands), past the 1e-5 bound.  So
// each staged chunk's big.big products go to a fresh accumulator (a 16th of
// the magnitude at D = 512) that is added to the f32 total in registers with
// ordinary rounding, and the small terms, ~2^-10 of the magnitude, to an
// accumulator of their own.

template <typename T, int WGM, int WGN>
struct StagePass {
  static constexpr int NT = WGM * WGN * kWG;         // consumer threads
  static constexpr int kBM = 64 * WGM;
  static constexpr int kARows = kBM * 8 / NT;        // A rows per consumer thread
  static constexpr int kBRows = kBN * 8 / NT;        // B rows per consumer thread
  static constexpr int kSmallOff = (kBM + kBN) * kRowBytes;

  // Make a landed stage ready for wgmma: for f32 split it into tf32 parts;
  // sum the norms the caller did not give.  Thread t takes the 16-byte chunks
  // t + i * NT of each tile: chunk t % 8 of rows t / 8 + i * NT / 8.
  static __device__ __forceinline__ void run(uint8_t* a_raw, uint8_t* b_raw, int t, bool own_a2,
                                             bool own_b2, float (&na)[kARows],
                                             float (&nb)[kBRows]) {
    if constexpr (Elem<T>::kSplit) {
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        const int off = (t + i * NT) * 16;
        na[i] += split_chunk(a_raw + off, a_raw + kSmallOff + off);
      }
#pragma unroll
      for (int i = 0; i < kBRows; ++i) {
        const int off = (t + i * NT) * 16;
        nb[i] += split_chunk(b_raw + off, b_raw + kSmallOff + off);
      }
      // The split values are generic-proxy writes that wgmma (async proxy)
      // reads, and every warpgroup reads chunks that others split.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");
    } else {
      if (own_a2) {
#pragma unroll
        for (int i = 0; i < kARows; ++i) na[i] += sq_chunk_bf16(a_raw + (t + i * NT) * 16);
      }
      if (own_b2) {
#pragma unroll
        for (int i = 0; i < kBRows; ++i) nb[i] += sq_chunk_bf16(b_raw + (t + i * NT) * 16);
      }
    }
  }
};

template <typename T, int WGM, int WGN, int STAGES>
__global__ void __launch_bounds__((WGM * WGN + 1) * kWG, 1)
rbf_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b,
                 const float* __restrict__ a2, const float* __restrict__ b2,
                 const float* __restrict__ ls_ptr, const float* __restrict__ var_ptr,
                 float ls_val, float var_val, float* __restrict__ out,
                 int M, int N, int D, int m_fast, int transposed) {
  using L = Layout<T, WGM, WGN, STAGES>;
  using P = StagePass<T, WGM, WGN>;
  constexpr int NWG = WGM * WGN;
  constexpr int BM = L::kBM;
  constexpr int NT = P::NT;
  constexpr int WN = kBN / WGN;  // columns of one warpgroup's tile
  constexpr int kAcc = WN / 2;   // accumulator registers a thread
  constexpr int kBK = Elem<T>::kBK;
  constexpr bool kSplit = Elem<T>::kSplit;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * L::kStageBytes);
  uint64_t* empty = full + STAGES;
  float* sA2 = reinterpret_cast<float*>(empty + STAGES);
  float* sB2 = sA2 + BM;

  const int m0 = (m_fast ? blockIdx.x : blockIdx.y) * BM;
  const int n0 = (m_fast ? blockIdx.y : blockIdx.x) * kBN;
  const int KB = (D + kBK - 1) / kBK;
  const int wg = threadIdx.x / kWG;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == NWG * kWG) {
      for (int kb = 0; kb < KB; ++kb) {
        const int s = kb % STAGES;
        if (kb >= STAGES) mbar_wait(&empty[s], (kb / STAGES - 1) & 1);
        uint8_t* st = smem + s * L::kStageBytes;
        mbar_expect_tx(&full[s], L::kTmaBytes);  // the full boxes, out-of-bounds zeros included
        tma_load_2d(st, &tma_a, &full[s], kb * kBK, m0);
        tma_load_2d(st + BM * kRowBytes, &tma_b, &full[s], kb * kBK, n0);
      }
    }
  } else {
    // ---- consumers ----
    // 240 registers each: 2 x 128 x 240 + 128 x 24 fits the SM's 64 K.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = threadIdx.x;  // 0..NT-1
    const int tw = t % kWG;
    const int wg_m = wg / WGN, wg_n = wg % WGN;
    const bool own_a2 = (a2 == nullptr);
    const bool own_b2 = (b2 == nullptr);

    float acc[kAcc], acc_blk[kAcc], acc_small[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = acc_blk[i] = acc_small[i] = 0.f;
    float na[P::kARows], nb[P::kBRows];
#pragma unroll
    for (int i = 0; i < P::kARows; ++i) na[i] = 0.f;
#pragma unroll
    for (int i = 0; i < P::kBRows; ++i) nb[i] = 0.f;

    auto a_tile = [&](int kb) { return smem + (kb % STAGES) * L::kStageBytes; };
    auto b_tile = [&](int kb) { return a_tile(kb) + BM * kRowBytes; };

    mbar_wait(&full[0], 0);
    P::run(a_tile(0), b_tile(0), t, own_a2, own_b2, na, nb);
    for (int kb = 0; kb < KB; ++kb) {
      // This warpgroup's rows of A and columns of B.
      const uint32_t a_addr = smem_u32(a_tile(kb)) + wg_m * 64 * kRowBytes;
      const uint32_t b_addr = smem_u32(b_tile(kb)) + wg_n * WN * kRowBytes;
      const uint64_t da = smem_desc(a_addr);
      const uint64_t db = smem_desc(b_addr);
      fence_acc(acc_blk);
      fence_acc(acc_small);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kKSteps; ++k) {
        if constexpr (kSplit) {
          const uint64_t da_small = smem_desc(a_addr + P::kSmallOff);
          const uint64_t db_small = smem_desc(b_addr + P::kSmallOff);
          Wgmma<WN>::tf32(acc_small, da_small + 2 * k, db + 2 * k, 1);
          Wgmma<WN>::tf32(acc_small, da + 2 * k, db_small + 2 * k, 1);
          Wgmma<WN>::tf32(acc_blk, da + 2 * k, db + 2 * k, k > 0);
        } else {
          Wgmma<WN>::bf16(acc_blk, da + 2 * k, db + 2 * k, k > 0);
        }
      }
      wgmma_commit();
      // Ready the next stage while the tensor cores work on this one.
      if (kb + 1 < KB) {
        mbar_wait(&full[(kb + 1) % STAGES], ((kb + 1) / STAGES) & 1);
        P::run(a_tile(kb + 1), b_tile(kb + 1), t, own_a2, own_b2, na, nb);
      }
      wgmma_wait<0>();
      fence_acc(acc_blk);
      fence_acc(acc_small);
      if (tw == 0) mbar_arrive(&empty[kb % STAGES]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += acc_blk[i];
    }
    if constexpr (kSplit) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += acc_small[i];
    }

    // ---- norms of the tile's rows and columns ----
    if (own_a2) {
#pragma unroll
      for (int i = 0; i < P::kARows; ++i) {
        const float v = row_sum8(na[i]);
        if ((t & 7) == 0) sA2[t / 8 + i * (NT / 8)] = v;
      }
    } else {
      for (int r = t; r < BM; r += NT) sA2[r] = (m0 + r < M) ? a2[m0 + r] : 0.f;
    }
    if (own_b2) {
#pragma unroll
      for (int i = 0; i < P::kBRows; ++i) {
        const float v = row_sum8(nb[i]);
        if ((t & 7) == 0) sB2[t / 8 + i * (NT / 8)] = v;
      }
    } else {
      for (int c = t; c < kBN; c += NT) sB2[c] = (n0 + c < N) ? b2[n0 + c] : 0.f;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");

    // ---- epilogue: accumulator fragment -> kernel values -> device memory ----
    // Fragment of m64nN f32: register i of lane l in warp w (of the warpgroup)
    // holds row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
    const float ls = ls_ptr ? ls_ptr[0] : ls_val;
    const float v = var_ptr ? var_ptr[0] : var_val;
    const float inv2l2 = 1.f / (2.f * ls * ls);
    const int lane = t % 32;
    const int r_base = wg_m * 64 + ((tw / 32) * 16) + lane / 4;
    const bool pairs = !transposed && (N % 2 == 0);
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int c = wg_n * WN + j * 8 + (lane % 4) * 2;
      const int gc = n0 + c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_base + 8 * h;
        const int gr = m0 + r;
        if (gr >= M || gc >= N) continue;
        const float k0 =
            v * expf(-fmaxf(sA2[r] + sB2[c] - 2.f * acc[4 * j + 2 * h], 0.f) * inv2l2);
        const float k1 =
            v * expf(-fmaxf(sA2[r] + sB2[c + 1] - 2.f * acc[4 * j + 2 * h + 1], 0.f) * inv2l2);
        if (pairs && gc + 1 < N) {
          *reinterpret_cast<float2*>(out + static_cast<size_t>(gr) * N + gc) = make_float2(k0, k1);
        } else if (!transposed) {
          out[static_cast<size_t>(gr) * N + gc] = k0;
          if (gc + 1 < N) out[static_cast<size_t>(gr) * N + gc + 1] = k1;
        } else {
          out[static_cast<size_t>(gc) * M + gr] = k0;
          if (gc + 1 < N) out[static_cast<size_t>(gc + 1) * M + gr] = k1;
        }
      }
    }
  }
}

// ---- host side -----------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: fetched once
// through the runtime's entry-point query, so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a row-major (rows, D) operand, boxes of (box_rows, one
// 128-byte chunk of D), 128-byte swizzle, out-of-bounds elements read as 0.
template <typename T>
CUresult make_map(CUtensorMap* map, const void* ptr, int rows, int D, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(Elem<T>::kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, Elem<T>::kTmaType, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kEncodeError = 10000;  // returned as kEncodeError + CUresult

template <typename T, int WGM, int WGN, int STAGES>
int launch(const void* a, const void* b, const float* a2, const float* b2, const float* ls_ptr,
           const float* var_ptr, float ls_val, float var_val, float* out, int M, int N, int D,
           int transposed, cudaStream_t stream) {
  using L = Layout<T, WGM, WGN, STAGES>;
  auto kernel = rbf_wgmma_kernel<T, WGM, WGN, STAGES>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap map_a, map_b;
  CUresult cr = make_map<T>(&map_a, a, M, D, L::kBM);
  if (cr != CUDA_SUCCESS) return kEncodeError + static_cast<int>(cr);
  cr = make_map<T>(&map_b, b, N, D, kBN);
  if (cr != CUDA_SUCCESS) return kEncodeError + static_cast<int>(cr);
  const int tiles_m = (M + L::kBM - 1) / L::kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  // The smaller operand's tiles vary fastest: the larger operand streams from
  // device memory once while the smaller one stays in L2.  This grid is
  // mirrored by ops/rbf_hopper.py::launch_grid, which refuses a launch past
  // CUDA's limits before it is made: change the two together.
  const int m_fast = M < N ? 1 : 0;
  const dim3 grid(m_fast ? tiles_m : tiles_n, m_fast ? tiles_n : tiles_m);
  kernel<<<grid, (WGM * WGN + 1) * kWG, L::kSmemBytes, stream>>>(
      map_a, map_b, a2, b2, ls_ptr, var_ptr, ls_val, var_val, out, M, N, D, m_fast, transposed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_variant(int variant, const void* a, const void* b, const float* a2, const float* b2,
                   const float* ls_ptr, const float* var_ptr, float ls_val, float var_val,
                   float* out, int M, int N, int D, int transposed, cudaStream_t s) {
  switch (variant) {
    case 0:  // 128 x 128 tiles: two warpgroups of 64 x 128, 3 stages
      return launch<T, 2, 1, 3>(a, b, a2, b2, ls_ptr, var_ptr, ls_val, var_val, out, M, N, D,
                                transposed, s);
    case 1:  // a 64 x 128 slab: two warpgroups of 64 x 64, 4 stages
      return launch<T, 1, 2, 4>(a, b, a2, b2, ls_ptr, var_ptr, ls_val, var_val, out, M, N, D,
                                transposed, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point, loaded with ctypes.  a: (M, D), b: (N, D), row-major, both
// float32 (dtype 0) or both bfloat16 (dtype 1), base pointers 16-byte aligned
// and D * element size a multiple of 16 bytes (TMA's rules).  a2 (M,) and b2
// (N,) are float32 squared row norms or null.  length_scale and var each
// point to one float32 on the device, or are null and then taken from
// ls_value / var_value.  out: (M, N) float32.  variant picks the tile
// (0: 128 x 128 with 3 stages; 1: a 64 x 128 slab with 4 stages, two
// warpgroups of 64 columns each);
// transposed != 0 computes the product with a and b swapped (so the tile's
// 64-row side lies on N) and stores it transposed.  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success), or 10000 + the
// CUresult when a tensor map cannot be encoded.
extern "C" int ital_rbf_wgmma(const void* a, const void* b, const void* a2, const void* b2,
                              const void* length_scale, const void* var, float ls_value,
                              float var_value, void* out, int M, int N, int D, int dtype,
                              int variant, int transposed, void* stream) {
  if (M <= 0 || N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* fa2 = static_cast<const float*>(a2);
  const float* fb2 = static_cast<const float*>(b2);
  if (transposed) {
    const void* t = a; a = b; b = t;
    const float* t2 = fa2; fa2 = fb2; fb2 = t2;
    const int tm = M; M = N; N = tm;
  }
  const float* fls = static_cast<const float*>(length_scale);
  const float* fvar = static_cast<const float*>(var);
  float* fout = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_variant<float>(variant, a, b, fa2, fb2, fls, fvar, ls_value, var_value, fout,
                                 M, N, D, transposed, s);
  }
  if (dtype == 1) {
    return launch_variant<__nv_bfloat16>(variant, a, b, fa2, fb2, fls, fvar, ls_value, var_value,
                                         fout, M, N, D, transposed, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
