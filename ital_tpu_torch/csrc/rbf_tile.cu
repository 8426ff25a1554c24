// RBF kernel block on Hopper: out[i, j] = var * exp(-max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0) / (2 ls^2)).
//
// Replaces the Pallas TPU kernel ital_tpu/ops/pallas_rbf.py::rbf_kernel_pallas
// (tile body _rbf_tile_kernel, pl.pallas_call at pallas_rbf.py:90).  In the
// port every RBF call of the interactive session goes through this kernel on a
// CUDA tensor (ital_tpu_torch/ops/kernels.py::rbf_kernel); the plain PyTorch
// version beside it serves CPU tensors.
//
// What bounds it on an H100: the session's largest call is (64, 25000, 512) in
// f32 (gp_fit's cross-kernel against the whole corpus).  It reads 51 MB of
// corpus for 1.6 GFLOP, 32 FLOP per byte.  Against the tensor cores' ridge
// (about 148 FLOP/byte in TF32, 295 in bf16) that is memory-bound: at
// 3.35 TB/s the read alone takes about 15 us.  This first design does its dot
// products as plain f32 FMAs on the CUDA cores (full f32, no silent TF32),
// whose ridge is about 20 FLOP/byte (67 TFLOP/s), so here the FMA issue rate
// is the bound (about 24 us).  The (4, 25000, 512) update call and the skinny
// (N, 3) calls move the same 51 MB for a tenth of the work or less, and are
// memory-bound outright.
//
// What the design does about it: one 256-thread block computes one output
// tile and walks the feature axis D in chunks of 32 that it stages in shared
// memory, so each corpus row is read from device memory once per tile row of
// the other operand (once in all for the skinny shapes, whose other operand
// fits one tile).  The tile shape follows the operands: 64 x 64 in general,
// 16 x 64 when M <= 16 and 64 x 16 when N <= 16, so a 4-row or 3-column call
// does not spend 15/16 of its FMAs on masked rows.  Norms come from the
// optional a2/b2 pointers (the cached corpus norms); where a pointer is null
// the block accumulates that side's norms in f32 from the staged values, so a
// bf16 corpus still gets f32 norms.  The distance and exp epilogue run in
// registers; ragged edges are masked, never padded.  length_scale and var are
// read from device memory (or passed by value), so a call never waits on the
// host.  The kernel allocates nothing: the caller passes the output.  The
// wide calls take the tensor-core route instead (rbf_wgmma.cu); this kernel
// keeps the skinny and unaligned ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBK = 32;       // feature-axis chunk staged in shared memory
constexpr int kThreads = 256;  // threads per block, for every tile shape

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One (TM, TN) output tile per block.  Thread (ty, tx) owns rows ty + i*TY and
// columns tx + j*TX, so neighbouring threads read neighbouring shared-memory
// words and write neighbouring output addresses.
template <typename T, int TM, int TN, int RM, int RN>
__global__ void __launch_bounds__(kThreads)
rbf_tile_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const float* __restrict__ a2, const float* __restrict__ b2,
                const float* __restrict__ length_scale, const float* __restrict__ var,
                float ls_value, float var_value, float* __restrict__ out, int M, int N, int D) {
  constexpr int TX = TN / RN;
  constexpr int TY = TM / RM;
  static_assert(TX * TY == kThreads, "tile shape must use every thread");
  static_assert(TM <= kThreads && TN <= kThreads, "one norm owner per row");

  // Transposed staging ([k][row]); the +1 keeps the transposing stores free
  // of bank conflicts.
  __shared__ float As[kBK][TM + 1];
  __shared__ float Bs[kBK][TN + 1];
  __shared__ float sa2[TM];
  __shared__ float sb2[TN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const bool own_a2 = (a2 == nullptr);
  const bool own_b2 = (b2 == nullptr);

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  float na = 0.f;  // squared norm of tile row `tid` (tid < TM), when own_a2
  float nb = 0.f;  // squared norm of tile column `tid` (tid < TN), when own_b2

  for (int k0 = 0; k0 < D; k0 += kBK) {
    // A warp reads 32 consecutive features of one row: coalesced.
    for (int e = tid; e < TM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < D) ? to_f32(a[static_cast<size_t>(gr) * D + gc]) : 0.f;
    }
    for (int e = tid; e < TN * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = n0 + r, gc = k0 + c;
      Bs[c][r] = (gr < N && gc < D) ? to_f32(b[static_cast<size_t>(gr) * D + gc]) : 0.f;
    }
    __syncthreads();

    if (own_a2 && tid < TM) {
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) na = fmaf(As[k][tid], As[k][tid], na);
    }
    if (own_b2 && tid < TN) {
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) nb = fmaf(Bs[k][tid], Bs[k][tid], nb);
    }

#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float ra[RM], rb[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) ra[i] = As[k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < RN; ++j) rb[j] = Bs[k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < TM) sa2[tid] = own_a2 ? na : (m0 + tid < M ? a2[m0 + tid] : 0.f);
  if (tid < TN) sb2[tid] = own_b2 ? nb : (n0 + tid < N ? b2[n0 + tid] : 0.f);
  __syncthreads();

  const float ls = length_scale ? length_scale[0] : ls_value;
  const float inv2l2 = 1.f / (2.f * ls * ls);
  const float v = var ? var[0] : var_value;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + i * TY;
    const int gr = m0 + r;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = tx + j * TX;
      const int gc = n0 + c;
      if (gc >= N) continue;
      const float d2 = fmaxf(sa2[r] + sb2[c] - 2.f * acc[i][j], 0.f);
      out[static_cast<size_t>(gr) * N + gc] = v * expf(-d2 * inv2l2);
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, const void* a2, const void* b2,
            const void* length_scale, const void* var, float ls_value, float var_value,
            void* out, int M, int N, int D, cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const float* fa2 = static_cast<const float*>(a2);
  const float* fb2 = static_cast<const float*>(b2);
  const float* fls = static_cast<const float*>(length_scale);
  const float* fvar = static_cast<const float*>(var);
  float* fout = static_cast<float*>(out);
  const dim3 block(kThreads);
  // These grids are mirrored by ops/rbf_hopper.py::launch_grid, which refuses
  // a launch past CUDA's limits before it is made: change the two together.
  if (M <= 16) {
    const dim3 grid((N + 63) / 64, (M + 15) / 16);
    rbf_tile_kernel<T, 16, 64, 1, 4><<<grid, block, 0, stream>>>(
        ta, tb, fa2, fb2, fls, fvar, ls_value, var_value, fout, M, N, D);
  } else if (N <= 16) {
    const dim3 grid((N + 15) / 16, (M + 63) / 64);
    rbf_tile_kernel<T, 64, 16, 4, 1><<<grid, block, 0, stream>>>(
        ta, tb, fa2, fb2, fls, fvar, ls_value, var_value, fout, M, N, D);
  } else {
    const dim3 grid((N + 63) / 64, (M + 63) / 64);
    rbf_tile_kernel<T, 64, 64, 4, 4><<<grid, block, 0, stream>>>(
        ta, tb, fa2, fb2, fls, fvar, ls_value, var_value, fout, M, N, D);
  }
}

}  // namespace

// C entry point, loaded with ctypes.  a: (M, D), b: (N, D), row-major and
// contiguous, both float32 (dtype 0) or both bfloat16 (dtype 1).  a2 (M,) and
// b2 (N,) are float32 squared row norms or null.  length_scale and var each
// point to one float32 on the device, or are null and then taken from
// ls_value / var_value.  out: (M, N) float32.  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int ital_rbf_tile(const void* a, const void* b, const void* a2, const void* b2,
                             const void* length_scale, const void* var, float ls_value,
                             float var_value, void* out, int M, int N, int D, int dtype,
                             void* stream) {
  if (M <= 0 || N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, b, a2, b2, length_scale, var, ls_value, var_value, out, M, N, D, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(a, b, a2, b2, length_scale, var, ls_value, var_value, out, M, N, D,
                           s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
