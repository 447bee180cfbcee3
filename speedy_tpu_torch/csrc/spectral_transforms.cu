// Spectral <-> grid transforms of a batch of fields, one kernel per
// direction, with the Fourier-coefficient intermediate held in shared
// memory.
//
// Replaces the JAX package's Pallas kernels
//   speedy_tpu/ops/pallas_transforms.py::fused_spec_to_grid (synthesis) and
//   speedy_tpu/ops/pallas_transforms.py::fused_grid_to_spec (analysis).
// Those expand the per-m Legendre tables into a dense block-diagonal matrix
// (23.6 MB in fp32 at T30) so that each stage is one TPU matmul. Here the
// kernels read the compact tables of ops/spectral.py directly:
//   cpol_inv, cpol_dir [mx, nx, il]   dft_syn, dft_ana [mx, 2, ix]
//
// Synthesis, [B, mx, nx, 2] -> [B, il, ix]. One block per (batch element,
// tile of tile_j latitudes):
//   stage 1  fm[j, m, r] = sum_n spec[b, m, n, r] * cpol_inv[m, n, j]
//   stage 2  grid[b, j, i] = sum_{m, r} fm[j, m, r] * dft_syn[m, r, i]
// Analysis, [B, il, ix] -> [B, mx, nx, 2]. One block per (batch element,
// tile of tile_m zonal wavenumbers):
//   stage 1  fm[j, m, r] = sum_i grid[b, j, i] * dft_ana[m, r, i]
//   stage 2  spec[b, m, n, r] = sum_j fm[j, m, r] * cpol_dir[m, n, j]
// Tiling by latitude (synthesis) or by wavenumber (analysis) keeps each
// block's intermediate small at every preset: tile_j * mx * 2 or
// il * tile_m * 2 values (T170, fp64, tile_j = 8 and tile_m = 4: 21.9 KB
// and 16.4 KB), and removes the inter-stage relayout that the TPU compiler
// could not lower.
//
// Bound on the H100: at the model's batches (25-57 fields at T30) both
// directions do 10-30 flops per byte they must move, at or above the
// card's ridge point outside the tensor cores (20 flops/byte in fp32, 10 in
// fp64), so the floating-point rate bounds them, at well under a
// microsecond at T30; in practice the kernels are latency-bound (one
// launch, a few hundred blocks, short dot products from L1/L2). This first
// version is plain CUDA: synthesis computes one Legendre sum per thread,
// then kRows latitudes of one longitude per thread; analysis gives each
// dot product to a warp, with the lanes along the contiguous axis and a
// shuffle sum at the end; operands come through the read-only cache; no
// tensor cores (TF32 would lose the fp32 parity).
//
// Types: fp32 accumulates in fp32, as the TPU kernel did. fp64 accumulates
// in fp64 (the TPU kernel's scratch was fp32 because that chip has no
// fp64), so the fp64 kernels agree with the einsum chain to rounding.
//
// C interface (ctypes): each entry point takes fp64 (0/1), the batch size,
// mx, nx, il, ix, the tile size, the data and table pointers and the CUDA
// stream, launches on that stream and returns the CUDA error code of the
// launch (0 on success). The wrapper is speedy_tpu_torch/ops/fused_transforms.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;     // latitudes per thread in synthesis stage 2
constexpr int kMaxMr = 8;    // (m, r) pairs per analysis block: 2 * tile_m

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
synthesis_kernel(int mx, int nx, int il, int ix, int tile_j, int n_tiles,
                 const T* __restrict__ spec, const T* __restrict__ cpol,
                 const T* __restrict__ dft, T* __restrict__ grid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* fm = reinterpret_cast<T*>(smem_raw);  // [tile_j][mx * 2]

  const int64_t b = blockIdx.x / n_tiles;
  const int j0 = (blockIdx.x % n_tiles) * tile_j;
  const int nj = min(tile_j, il - j0);
  const int mr_n = 2 * mx;
  const T* s = spec + b * mx * nx * 2;

  // stage 1: Legendre sums; j fastest, so a warp reads cpol rows coalesced
  for (int idx = threadIdx.x; idx < mr_n * nj; idx += blockDim.x) {
    const int jj = idx % nj;
    const int mr = idx / nj;
    const int m = mr >> 1;
    const T* sp = s + (int64_t)m * nx * 2 + (mr & 1);
    const T* cp = cpol + (int64_t)m * nx * il + j0 + jj;
    T acc = T(0);
    for (int n = 0; n < nx; ++n) {
      acc += __ldg(sp + 2 * n) * __ldg(cp + (int64_t)n * il);
    }
    fm[jj * mr_n + mr] = acc;
  }
  __syncthreads();

  // stage 2: zonal DFT; each thread takes kRows latitudes of one
  // longitude, so each dft value it reads serves kRows outputs; i fastest,
  // so dft reads and grid writes coalesce (rows of fm past nj are read but
  // their sums are not stored; tile_j is a multiple of kRows)
  T* g = grid + (b * il + j0) * ix;
  const int n_groups = (nj + kRows - 1) / kRows;
  for (int idx = threadIdx.x; idx < n_groups * ix; idx += blockDim.x) {
    const int i = idx % ix;
    const int jj0 = (idx / ix) * kRows;
    const T* f = fm + jj0 * mr_n;
    T acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = T(0);
    for (int mr = 0; mr < mr_n; ++mr) {
      const T d = __ldg(dft + (int64_t)mr * ix + i);
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[q] += f[q * mr_n + mr] * d;
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (jj0 + q < nj) g[(int64_t)(jj0 + q) * ix + i] = acc[q];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
analysis_kernel(int mx, int nx, int il, int ix, int tile_m, int n_tiles,
                const T* __restrict__ grid, const T* __restrict__ dft,
                const T* __restrict__ cpol, T* __restrict__ spec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* fm = reinterpret_cast<T*>(smem_raw);  // [nm * 2][il]

  const int64_t b = blockIdx.x / n_tiles;
  const int m0 = (blockIdx.x % n_tiles) * tile_m;
  const int nm = min(tile_m, mx - m0);
  const int mr_n = 2 * nm;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const T* g = grid + b * il * ix;
  const T* d0 = dft + (int64_t)(2 * m0) * ix;

  // stage 1: zonal DFT, one warp per latitude with the lanes along
  // longitude (coalesced reads of the grid row and the dft rows), then a
  // sum over the warp
  for (int j = warp; j < il; j += n_warps) {
    const T* row = g + (int64_t)j * ix;
    T acc[kMaxMr];
#pragma unroll
    for (int q = 0; q < kMaxMr; ++q) acc[q] = T(0);
    for (int i = lane; i < ix; i += 32) {
      const T x = __ldg(row + i);
#pragma unroll
      for (int q = 0; q < kMaxMr; ++q) {
        if (q < mr_n) acc[q] += x * __ldg(d0 + (int64_t)q * ix + i);
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxMr; ++q) {
      const T v = warp_sum(acc[q]);
      if (lane == 0 && q < mr_n) fm[q * il + j] = v;
    }
  }
  __syncthreads();

  // stage 2: Legendre sums over latitude (Gaussian weights in cpol_dir),
  // one warp per (m, n) with the lanes along latitude
  T* out = spec + (b * mx + m0) * nx * 2;
  for (int p = warp; p < nm * nx; p += n_warps) {
    const int mm = p / nx;
    const T* cp = cpol + ((int64_t)(m0 + mm) * nx + p % nx) * il;
    const T* f0 = fm + 2 * mm * il;
    T a0 = T(0), a1 = T(0);
    for (int j = lane; j < il; j += 32) {
      const T c = __ldg(cp + j);
      a0 += f0[j] * c;
      a1 += f0[il + j] * c;
    }
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    if (lane == 0) {
      out[2 * p] = a0;
      out[2 * p + 1] = a1;
    }
  }
}

template <typename T>
int launch_synthesis(int batch, int mx, int nx, int il, int ix, int tile_j,
                     const void* spec, const void* cpol, const void* dft,
                     void* grid, cudaStream_t stream) {
  if (tile_j <= 0 || tile_j % kRows) return (int)cudaErrorInvalidValue;
  const int n_tiles = (il + tile_j - 1) / tile_j;
  const size_t smem = sizeof(T) * (size_t)tile_j * mx * 2;
  synthesis_kernel<T><<<batch * n_tiles, kThreads, smem, stream>>>(
      mx, nx, il, ix, tile_j, n_tiles, static_cast<const T*>(spec),
      static_cast<const T*>(cpol), static_cast<const T*>(dft),
      static_cast<T*>(grid));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_analysis(int batch, int mx, int nx, int il, int ix, int tile_m,
                    const void* grid, const void* dft, const void* cpol,
                    void* spec, cudaStream_t stream) {
  if (tile_m <= 0 || 2 * tile_m > kMaxMr) return (int)cudaErrorInvalidValue;
  const int n_tiles = (mx + tile_m - 1) / tile_m;
  const size_t smem = sizeof(T) * (size_t)il * tile_m * 2;
  analysis_kernel<T><<<batch * n_tiles, kThreads, smem, stream>>>(
      mx, nx, il, ix, tile_m, n_tiles, static_cast<const T*>(grid),
      static_cast<const T*>(dft), static_cast<const T*>(cpol),
      static_cast<T*>(spec));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spectral_synthesis_launch(int fp64, int batch, int mx, int nx,
                                         int il, int ix, int tile_j,
                                         const void* spec,
                                         const void* cpol_inv,
                                         const void* dft_syn, void* grid,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp64 ? launch_synthesis<double>(batch, mx, nx, il, ix, tile_j, spec,
                                         cpol_inv, dft_syn, grid, s)
              : launch_synthesis<float>(batch, mx, nx, il, ix, tile_j, spec,
                                        cpol_inv, dft_syn, grid, s);
}

extern "C" int spectral_analysis_launch(int fp64, int batch, int mx, int nx,
                                        int il, int ix, int tile_m,
                                        const void* grid, const void* dft_ana,
                                        const void* cpol_dir, void* spec,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp64 ? launch_analysis<double>(batch, mx, nx, il, ix, tile_m, grid,
                                        dft_ana, cpol_dir, spec, s)
              : launch_analysis<float>(batch, mx, nx, il, ix, tile_m, grid,
                                       dft_ana, cpol_dir, spec, s);
}
