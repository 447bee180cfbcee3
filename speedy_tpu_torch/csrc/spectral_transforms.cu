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
// Tiling by latitude keeps the block's intermediate small at every preset
// (tile_j * mx * 2 values, 21.9 KB at T170 fp64 with tile_j = 8) and removes
// the inter-stage relayout that the TPU compiler could not lower. Stage 1
// computes one Legendre sum per thread, stage 2 kRows latitudes of one
// longitude per thread; operands come through the read-only cache.
//
// Analysis, [B, il, ix] -> [B, mx, nx, 2]: two small GEMMs fused in one
// block, register-tiled, operands in shared memory.
//   stage 1  fm[f, m, r, j] = sum_i grid[b, j, i] * dft_ana[m, r, i]
//   stage 2  spec[b, m, n, r] = sum_j cpol_dir[m, n, j] * fm[f, m, r, j]
// One block of 256 threads takes FB fields x TM zonal wavenumbers (template
// parameters; the wrapper picks them per preset and type). Stage 1 stages
// the block's 2*TM dft rows once, then the FB fields' grid rows in chunks of
// jc latitudes; each thread accumulates RJ rows x 2*TM (m, r) in registers
// (RJ = 4, or 2 at TM = 8) over a slice of i. Stage 2 stages the cpol_dir
// rows [TM, nc, il] in chunks of nc values of n (where the slice fits beside
// stage 1's data, together with stage 1's first chunk: one round of loads);
// each thread accumulates (FB fields x 2 r) x kAnaRN values of n over a
// slice of j, so each table value it loads serves 2*FB outputs. The slices
// (split-K) give every thread work at the model's small sizes; their
// partial sums go through shared memory (the buffer the chunk was staged
// in), and all threads sum them in a fixed order, so the result is
// deterministic. The intermediate fm[FB, 2*TM, il] stays in shared memory.
//
// Bound on the H100: the arithmetic is small (T30, B=48: 0.47 us at the fp32
// peak outside the tensor cores; T85, B=256: 49.9 us), but fusing the two
// GEMMs in one block makes every block read its own copy of its operands:
// each field mx/TM times, the cpol_dir slice B/FB times, where the einsum
// chain reads each once and moves the intermediate through memory instead.
// With plain loads through registers (up to kStageBatch 16-byte loads in
// flight per thread) that traffic from L2, not the FMAs, is what the kernel
// waits on at every preset.
// What the design does about PR 2's analysis kernel:
//  1. no shuffle trees: a thread owns whole outputs of its register tile; the
//     split-K partials are summed from shared memory once per output;
//  2. no dependent loads from L2 inside the loops: every operand is staged
//     into shared memory with coalesced 16-byte loads, all of a thread's
//     batch issued before any store, the row walk free of divisions; the
//     inner loops read shared memory only (rows padded to an odd number of
//     16-byte vectors, so 8 consecutive rows read at one column hit distinct
//     banks; table rows are read by the whole warp at one address, a
//     broadcast);
//  3. reuse: a block holds FB fields and TM wavenumbers, so the cpol_dir
//     slice is fetched B/FB times instead of B, each dft row serves FB*il
//     rows, and each field is fetched mx/TM times (8x at T30 with TM = 4,
//     as before; 11x at T85 with TM = 8, against 22x);
//  4. the truncation is skipped: stage 2 stages and sums only the rows
//     n < extent[m] that the triangular truncation keeps (the wrapper derives
//     extent once from the nonzero rows of cpol_dir; the kernel gets it by
//     value, in the constant bank) and writes zeros for the rest.
// Shared memory above the 48 KB a launch gets by default is requested once
// per instantiation and device (cudaFuncSetAttribute), up to kMaxSmem.
//
// Types: fp32 accumulates in fp32, as the TPU kernel did. fp64 accumulates
// in fp64 (the TPU kernel's scratch was fp32 because that chip has no
// fp64), so the fp64 kernels agree with the einsum chain to rounding. No
// tensor cores (TF32 would lose the fp32 parity).
//
// C interface (ctypes): each entry point takes fp64 (0/1), the batch size,
// mx, nx, il, ix, the tile sizes, the data and table pointers and the CUDA
// stream, launches on that stream and returns the CUDA error code of the
// launch (0 on success). spectral_analysis_smem_bytes gives the analysis
// launch's shared memory. The wrapper is
// speedy_tpu_torch/ops/fused_transforms.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;     // latitudes per thread in synthesis stage 2

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

// ---------------------------------------------------------------------------
// Analysis

constexpr int kAnaThreads = 256;
constexpr int kAnaRN = 2;          // stage 2: values of n per thread
constexpr int kStageBatch = 16;    // 16-byte loads in flight per thread
constexpr int kStagePairBatch = 8; // the same for each of two tables
constexpr int kMaxM = 256;         // most zonal wavenumbers (T170: 171)
constexpr int kMaxSmem = 232448;   // 227 KB: the most a block may ask for

// Stage 1's latitude rows per thread: a thread sums 16 (m, r) x row values
// at TM <= 8; a grid chunk has at most kAnaThreads * ana_rj(TM) rows.
__host__ __device__ constexpr int ana_rj(int tm) { return tm >= 8 ? 2 : 4; }

// Per zonal wavenumber m, one past the last n the truncation keeps; passed
// by value as a __grid_constant__ parameter, so it is read from the
// constant bank with no load from device memory.
struct AnaExtents {
  int n[kMaxM];
};

// 16-byte vectors (4 floats or 2 doubles) and (re, im) pairs
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using V = float4;
  using P = float2;
  static constexpr int kN = 4;
  __device__ static V zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static P pair(float a, float b) { return make_float2(a, b); }
};
template <> struct Vec16<double> {
  using V = double2;
  using P = double2;
  static constexpr int kN = 2;
  __device__ static V zero() { return make_double2(0.0, 0.0); }
  __device__ static P pair(double a, double b) { return make_double2(a, b); }
};

template <typename V>
__device__ __forceinline__ auto comp(const V& v, int k) -> decltype(v.x) {
  return (&v.x)[k];
}

// Row stride in shared memory, in values: the row length (a multiple of the
// vector) rounded up to an odd number of vectors, so that 8 consecutive rows
// read at one column fall in distinct banks.
__host__ __device__ inline int padded_row(int n, int vn) {
  return (n / vn) % 2 == 0 ? n + vn : n;
}

// Shared-memory layout of one analysis block, in values: fm [fb][2 tm][ilp];
// stage 1's region, the dft rows [2 tm][ixp] and the grid chunk
// [fb * jc][ixp]; stage 2's region, the cpol_dir chunk [tm][nc][ilp] (or at
// least one set of its partial sums). The two regions overlap unless the
// cpol_dir slice is staged early, together with stage 1's first chunk.
struct AnaLayout {
  int ilp, ixp, fm, stage1, stage2;
};

__host__ __device__ inline AnaLayout ana_layout(int fb, int tm, int il,
                                                int ix, int jc, int nc,
                                                int vn) {
  AnaLayout l;
  l.ilp = padded_row(il, vn);
  l.ixp = padded_row(ix, vn);
  l.fm = fb * 2 * tm * l.ilp;
  l.stage1 = (2 * tm + fb * jc) * l.ixp;
  const int items = tm * ((nc + kAnaRN - 1) / kAnaRN);
  const int cpol = tm * nc * l.ilp;
  const int partial = items * 2 * fb * kAnaRN;
  l.stage2 = cpol > partial ? cpol : partial;
  return l;
}

inline size_t ana_smem_bytes(int fp64, int fb, int tm, int il, int ix,
                             int jc, int nc, int early) {
  const int size = fp64 ? 8 : 4;
  const AnaLayout l = ana_layout(fb, tm, il, ix, jc, nc, 16 / size);
  const int work = early ? l.stage1 + l.stage2
                         : (l.stage1 > l.stage2 ? l.stage1 : l.stage2);
  return (size_t)size * (l.fm + work);
}

// Stages rows of 16-byte vectors into shared memory. The rows form a list
// of segments (segment 0 has len0 rows, the others len); a thread takes
// column c of rows row, row + rs, ..., walking the segments without
// dividing. issue() starts up to B loads, commit() stores them; src(seg, rr)
// is the source of row rr of segment seg, or nullptr for zeros.
template <typename T, int B>
struct Stager {
  using V = typename Vec16<T>::V;
  V buf[B];
  int row0;  // the first row of the batch in flight
  int row, seg, rr, rs, c, stride, len0, len;

  __device__ void start(int r0, int step, int col, int row_stride, int l0,
                        int l, int rows) {
    rs = step;
    c = col;
    stride = row_stride;
    len0 = l0;
    len = l;
    row = r0 < step ? r0 : rows;  // threads past the last full row idle
    if (r0 < l0) {
      seg = 0;
      rr = r0;
    } else {
      seg = 1 + (r0 - l0) / l;
      rr = (r0 - l0) % l;
    }
  }

  template <typename Src>
  __device__ void issue(int rows, Src src) {
    row0 = row;
#pragma unroll
    for (int q = 0; q < B; ++q) {
      buf[q] = Vec16<T>::zero();
      if (row < rows) {
        const T* p = src(seg, rr);
        if (p) buf[q] = __ldg(reinterpret_cast<const V*>(p) + c);
        row += rs;
        rr += rs;
        while (rr >= (seg == 0 ? len0 : len)) {
          rr -= seg == 0 ? len0 : len;
          ++seg;
        }
      }
    }
  }

  __device__ void commit(T* base) {
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int r = row0 + q * rs;
      if (r < row) reinterpret_cast<V*>(base)[r * stride + c] = buf[q];
    }
  }

  // issue and commit until all rows are staged
  template <typename Src>
  __device__ void run(int rows, Src src, T* base) {
    while (row < rows) {
      issue(rows, src);
      commit(base);
    }
  }
};

template <typename T, int FB, int TM>
__global__ void __launch_bounds__(kAnaThreads, 2)
analysis_kernel(int batch, int mx, int nx, int il, int ix, int jc, int nc,
                int early, const T* __restrict__ grid,
                const T* __restrict__ dft, const T* __restrict__ cpol,
                const __grid_constant__ AnaExtents extent,
                T* __restrict__ spec) {
  using V = typename Vec16<T>::V;
  using P = typename Vec16<T>::P;
  constexpr int VN = Vec16<T>::kN;
  constexpr int MR = 2 * TM;               // (m, r) rows of the block
  constexpr int RJ = ana_rj(TM);           // stage 1: latitude rows/thread
  constexpr int OUT = 2 * FB * kAnaRN;     // stage-2 outputs per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const AnaLayout lay = ana_layout(FB, TM, il, ix, jc, nc, VN);
  T* fm = reinterpret_cast<T*>(smem_raw);  // [FB][MR][ilp]
  T* u = fm + lay.fm;                      // stage 1: dft rows, grid chunk
  T* g_s = u + MR * lay.ixp;               // the chunk, then its partials
  T* c_s = early ? u + lay.stage1 : u;     // stage 2: cpol_dir, partials
  const int ilv = lay.ilp / VN, ixv = lay.ixp / VN;
  const int nvi = ix / VN, nvj = il / VN;

  const int tid = threadIdx.x;
  const int n_mt = (mx + TM - 1) / TM;
  const int m0 = (blockIdx.x % n_mt) * TM;
  const int b0 = (blockIdx.x / n_mt) * FB;
  const int nf = min(FB, batch - b0);
  const int nm = min(TM, mx - m0);
  const int* ext = extent.n + m0;          // the block's extents

  // ---- stage 1: zonal DFT. Thread (g, ks) owns rows g + k*G (k < RJ) of
  // the chunk, all MR (m, r) rows, and the ks-th slice of i.
  const int R = FB * jc;                   // rows (field, latitude) a chunk
  const int G = (R + RJ - 1) / RJ;
  const int KS = max(1, min(min(kAnaThreads / G, nvi), lay.ixp / MR));
  const int g = tid % G, ks = tid / G;
  const bool on1 = ks < KS;
  const int v0 = on1 ? ks * nvi / KS : 0;
  const int v1 = on1 ? (ks + 1) * nvi / KS : 0;
  int rows1[RJ];
#pragma unroll
  for (int k = 0; k < RJ; ++k) rows1[k] = min(g + k * G, R - 1) * ixv;
  const V* dft_v = reinterpret_cast<const V*>(u);
  const V* g_v = reinterpret_cast<const V*>(g_s);
  const int r1 = tid / nvi, rs1 = kAnaThreads / nvi;
  const int r2 = tid / nvj, rs2 = kAnaThreads / nvj;

  for (int j0 = 0; j0 < il; j0 += jc) {
    // the dft rows (first chunk only) and the chunk's grid rows; with
    // `early`, the whole cpol_dir slice too, all loads issued before any
    // store
    const bool first = j0 == 0;
    {
      const int rows = first ? MR + R : R;
      auto src1 = [&](int seg, int rr) -> const T* {
        if (first) {
          if (seg == 0) {
            return rr < 2 * nm ? dft + ((int64_t)2 * m0 + rr) * ix : nullptr;
          }
          --seg;
        }
        return seg < nf ? grid + ((int64_t)(b0 + seg) * il + j0 + rr) * ix
                        : nullptr;
      };
      T* base1 = first ? u : g_s;
      if (early && first) {
        // both tables' first batches in flight together
        Stager<T, kStagePairBatch> s, t;
        s.start(r1, rs1, tid - r1 * nvi, ixv, MR, jc, rows);
        t.start(r2, rs2, tid - r2 * nvj, ilv, nc, nc, TM * nc);
        auto src2 = [&](int seg, int rr) -> const T* {
          return seg < nm && rr < ext[seg]
                     ? cpol + ((int64_t)(m0 + seg) * nx + rr) * il
                     : nullptr;
        };
        s.issue(rows, src1);
        t.issue(TM * nc, src2);
        s.commit(base1);
        t.commit(c_s);
        t.run(TM * nc, src2, c_s);
        s.run(rows, src1, base1);
      } else {
        Stager<T, kStageBatch> s;
        s.start(r1, rs1, tid - r1 * nvi, ixv, first ? MR : jc, jc, rows);
        s.run(rows, src1, base1);
      }
    }
    __syncthreads();

    T acc[RJ][MR];
#pragma unroll
    for (int k = 0; k < RJ; ++k) {
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) acc[k][mr] = T(0);
    }
    for (int v = v0; v < v1; ++v) {
      V x[RJ];
#pragma unroll
      for (int k = 0; k < RJ; ++k) x[k] = g_v[rows1[k] + v];
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) {
        const V d = dft_v[mr * ixv + v];
#pragma unroll
        for (int k = 0; k < RJ; ++k) {
#pragma unroll
          for (int q = 0; q < VN; ++q) acc[k][mr] += comp(x[k], q) * comp(d, q);
        }
      }
    }
    __syncthreads();  // the chunk is read; its buffer takes the partials

    if (on1) {
#pragma unroll
      for (int k = 0; k < RJ; ++k) {
        const int r = g + k * G;
        if (r < R) {
#pragma unroll
          for (int mr = 0; mr < MR; ++mr) {
            g_s[(ks * MR + mr) * R + r] = acc[k][mr];
          }
        }
      }
    }
    __syncthreads();
    // every thread sums the partials of some (m, r) x row outputs
    for (int o = tid; o < MR * R; o += kAnaThreads) {
      const int mr = o / R, r = o - mr * R;
      const int f = r / jc, jj = r - f * jc;
      const T* part = g_s + o;
      T sum = part[0];
#pragma unroll 4
      for (int p = 1; p < KS; ++p) sum += part[p * MR * R];
      fm[(f * MR + mr) * lay.ilp + j0 + jj] = sum;
    }
    __syncthreads();
  }

  // ---- stage 2: Legendre sums over latitude. Item it = (a2, g2) takes the
  // chunk's rows n = g2 + q*NG (q < kAnaRN) of wavenumber m0 + a2, for all
  // FB fields and both r; thread (it, ks2) sums the ks2-th slice of j.
  const int NG = (nc + kAnaRN - 1) / kAnaRN;
  const int NI = TM * NG;
  const int KS2 = max(1, min(min(kAnaThreads / NI, nvj),
                             lay.stage2 / (NI * OUT)));
  const int it = tid % NI, ks2 = tid / NI;
  const int a2 = it / NG, g2 = it % NG;
  const int ext2 = a2 < nm ? ext[a2] : 0;
  const bool on2 = ks2 < KS2;
  const int w0 = on2 ? ks2 * nvj / KS2 : 0;
  const int w1 = on2 ? (ks2 + 1) * nvj / KS2 : 0;
  int rows2[kAnaRN];
#pragma unroll
  for (int q = 0; q < kAnaRN; ++q) {
    rows2[q] = (a2 * nc + min(g2 + q * NG, nc - 1)) * ilv;
  }
  const V* c_v = reinterpret_cast<const V*>(c_s);
  const V* fm_v = reinterpret_cast<const V*>(fm);
  int n_keep = 0;                          // the block's largest extent
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    if (a < nm) n_keep = max(n_keep, ext[a]);
  }

  for (int n0 = 0; n0 < n_keep; n0 += nc) {
    if (!early) {
      Stager<T, kStageBatch> t;
      t.start(r2, rs2, tid - r2 * nvj, ilv, nc, nc, TM * nc);
      t.run(TM * nc, [&](int seg, int rr) -> const T* {
        return seg < nm && n0 + rr < ext[seg]
                   ? cpol + ((int64_t)(m0 + seg) * nx + n0 + rr) * il
                   : nullptr;
      }, c_s);
      __syncthreads();
    }

    const bool active = on2 && n0 + g2 < ext2;
    T acc[FB][2][kAnaRN];
#pragma unroll
    for (int f = 0; f < FB; ++f) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int q = 0; q < kAnaRN; ++q) acc[f][r][q] = T(0);
      }
    }
    if (active) {
      for (int w = w0; w < w1; ++w) {
        V c[kAnaRN];
#pragma unroll
        for (int q = 0; q < kAnaRN; ++q) c[q] = c_v[rows2[q] + w];
#pragma unroll
        for (int f = 0; f < FB; ++f) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const V x = fm_v[(f * MR + 2 * a2 + r) * ilv + w];
#pragma unroll
            for (int q = 0; q < kAnaRN; ++q) {
#pragma unroll
              for (int e = 0; e < VN; ++e) {
                acc[f][r][q] += comp(x, e) * comp(c[q], e);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the chunk is read; its buffer takes the partials

    if (active) {
#pragma unroll
      for (int f = 0; f < FB; ++f) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int q = 0; q < kAnaRN; ++q) {
            c_s[(ks2 * OUT + (f * 2 + r) * kAnaRN + q) * NI + it] =
                acc[f][r][q];
          }
        }
      }
    }
    __syncthreads();
    // every thread sums the partials of some outputs: slot (f, r, q) of
    // item (a, g), that is spec[b0 + f, m0 + a, n0 + g + q * NG, r]
    for (int o = tid; o < OUT * NI; o += kAnaThreads) {
      const int e = o / NI, item = o - e * NI;
      const int a = item / NG, nn = item - a * NG + (e % kAnaRN) * NG;
      const int f = e / (2 * kAnaRN), r = (e / kAnaRN) & 1;
      if (f >= nf || a >= nm || nn >= nc || n0 + nn >= ext[a]) continue;
      const T* part = c_s + o;
      T sum = part[0];
#pragma unroll 4
      for (int p = 1; p < KS2; ++p) sum += part[p * OUT * NI];
      spec[(((int64_t)(b0 + f) * mx + m0 + a) * nx + n0 + nn) * 2 + r] = sum;
    }
    __syncthreads();
  }

  // the pairs the truncation drops are zero and are not computed
  for (int n = tid; n < nx; n += kAnaThreads) {
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      if (a >= nm || n < ext[a]) continue;
#pragma unroll
      for (int f = 0; f < FB; ++f) {
        if (f < nf) {
          reinterpret_cast<P*>(spec)[((int64_t)(b0 + f) * mx + m0 + a) * nx +
                                     n] = Vec16<T>::pair(0, 0);
        }
      }
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

template <typename T, int FB, int TM>
int launch_analysis(int batch, int mx, int nx, int il, int ix, int jc,
                    int nc, int early, const void* grid, const void* dft,
                    const void* cpol, const int* extent, void* spec,
                    cudaStream_t stream) {
  constexpr int VN = Vec16<T>::kN;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(grid) | reinterpret_cast<uintptr_t>(dft) |
        reinterpret_cast<uintptr_t>(cpol)) & 15) == 0;
  if (!aligned || mx > kMaxM || il % VN || ix % VN || ix < 2 * TM ||
      jc <= 0 || il % jc || FB * jc > kAnaThreads * ana_rj(TM) || nc <= 0 ||
      TM * ((nc + kAnaRN - 1) / kAnaRN) > kAnaThreads || (early && nc < nx)) {
    return (int)cudaErrorInvalidValue;
  }
  AnaExtents ext = {};
  for (int m = 0; m < mx; ++m) ext.n[m] = extent[m];
  const size_t smem =
      ana_smem_bytes(sizeof(T) == 8, FB, TM, il, ix, jc, nc, early);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static unsigned opted_in = 0;  // devices where the opt-in was made
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && !((opted_in >> dev) & 1u)) {
    err = cudaFuncSetAttribute(analysis_kernel<T, FB, TM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1u << dev;
  }
  const int blocks = ((batch + FB - 1) / FB) * ((mx + TM - 1) / TM);
  analysis_kernel<T, FB, TM><<<blocks, kAnaThreads, smem, stream>>>(
      batch, mx, nx, il, ix, jc, nc, early, static_cast<const T*>(grid),
      static_cast<const T*>(dft), static_cast<const T*>(cpol), ext,
      static_cast<T*>(spec));
  return (int)cudaGetLastError();
}

// The (FB, TM) tiles the analysis kernel is built for; the wrapper's
// ANA_BUILT_TILES lists the same.
#define ANA_TILES(X) \
  X(1, 4) X(2, 2) X(2, 4) X(4, 2) X(4, 4) X(1, 8) X(2, 8) X(4, 8)

template <typename T>
int dispatch_analysis(int fb, int tm, int batch, int mx, int nx, int il,
                      int ix, int jc, int nc, int early, const void* grid,
                      const void* dft, const void* cpol, const int* extent,
                      void* spec, cudaStream_t stream) {
#define ANA_CASE(F, M)                                                     \
  if (fb == F && tm == M) {                                                \
    return launch_analysis<T, F, M>(batch, mx, nx, il, ix, jc, nc, early,  \
                                    grid, dft, cpol, extent, spec, stream);\
  }
  ANA_TILES(ANA_CASE)
#undef ANA_CASE
  return (int)cudaErrorInvalidValue;
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
                                        int il, int ix, int fb, int tm,
                                        int jc, int nc, int early,
                                        const void* grid,
                                        const void* dft_ana,
                                        const void* cpol_dir,
                                        const int* extent, void* spec,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp64 ? dispatch_analysis<double>(fb, tm, batch, mx, nx, il, ix, jc,
                                          nc, early, grid, dft_ana, cpol_dir,
                                          extent, spec, s)
              : dispatch_analysis<float>(fb, tm, batch, mx, nx, il, ix, jc,
                                         nc, early, grid, dft_ana, cpol_dir,
                                         extent, spec, s);
}

extern "C" long long spectral_analysis_smem_bytes(int fp64, int fb, int tm,
                                                  int il, int ix, int jc,
                                                  int nc, int early) {
  return (long long)ana_smem_bytes(fp64, fb, tm, il, ix, jc, nc, early);
}
