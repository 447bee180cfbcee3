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
// Synthesis, [B, mx, nx, 2] -> [B, il, ix]: two small GEMMs fused in one
// block, register-tiled, operands staged in shared memory.
//   stage 1  fm[f, j, m, r] = sum_n spec[b, m, n, r] * cpol_inv[m, n, j]
//   stage 2  grid[b, j, i] = sum_{m, r} fm[f, j, m, r] * dft_syn[m, r, i]
// One block of 256 threads takes FB fields x TJ latitudes x ti longitudes
// (FB, TJ template parameters; the wrapper picks them per preset, type and
// batch, and ti, the widest divisor of ix the thread tile holds) and walks
// the zonal wavenumbers in chunks of mc. Per chunk it copies the spectra
// (rows n < extent[m] only), the cpol_inv slice [mc, n < extent, TJ] and
// the chunk's dft rows [2 mc, ti] into shared memory with cp.async (a warp
// per wavenumber, so every lane starts a copy; the dft rows in a second
// group, in flight during stage 1). Stage 1: an item (m, latitude pair)
// sums over n for all FB fields and both r, so each pair of table values
// serves 4 FB outputs and the FB spectra at n come in vector loads (a
// broadcast); where the chunk has few items, 2 or 4 adjacent lanes split
// the sum over n and join it by a fixed butterfly. fm [2 mc, FB TJ] stays
// in shared memory. Stage 2: a thread holds RJ rows (field, latitude) x RI
// longitudes of the output in registers (RJ = 4, or 8 at FB TJ = 64; RI a
// template parameter, 1-16) over the whole wavenumber loop and stores each
// output once, longitudes fastest; the fm rows it reads are a broadcast,
// the dft rows conflict-free. The m = 0 sine row of the DFT, which is zero,
// is neither copied nor summed.
//
// Bound on the H100: the operations (T30, B=57: 0.56 us at the fp32 peak
// outside the tensor cores; T85, B=256: 49.9 us) and the bytes of the
// inputs and output are far below what the kernel takes. What it waits on
// is the operand traffic from L2 that the fusion duplicates: a call moves
// about (B/FB) (il/TJ) (ix/ti) (FB S + TJ C + 2 mx ti) values, S the kept
// values of a spectrum and C the kept cpol_inv values of one latitude (at
// T85 fp32 with (4, 16), 535 KB a block, 274 MB a call at B=256). A block's
// copies start at the rate L2 delivers to one SM (~20 bytes a cycle on the
// H100), and a block copies, then sums stage 1, then stage 2, in series:
// at T85 B=256 the copies took 37% of a block's cycles, stage 1 29% and
// stage 2 30% before stage 1 was reworked as above. Double-buffering the
// chunks does not help (issuing the next chunk's copies stalls the
// issuing warps as long, and halving mc doubles the barriers); producer
// warps or bulk copies would.
// What the design does about the earlier synthesis kernel (one field and
// 8 latitudes per block, operands read from L2 in its loops):
//  1. reuse: a block holds FB fields and TJ latitudes, so the dft table is
//     fetched B/FB x il/TJ times instead of B x il/8, the cpol_inv slice
//     B/FB times, each field il/TJ times; the tile is picked by the traffic
//     it causes against the blocks it gives 132 SMs (small at T30 and small
//     batches, (4, 16) at T85 B=256);
//  2. no dependent loads from L2 inside the loops: every operand is copied
//     into shared memory with coalesced 16-byte (8-byte for one fp32 pair)
//     copies, and the inner loops read shared memory only (rows of the
//     cpol_inv slice and of the spectra bank-spread, so the wavenumbers a
//     warp reads at once fall in distinct banks);
//  3. register tiles: stage 2 does RJ x RI FMAs for RJ/4 + RI loads from
//     shared memory (64 for 10 at RJ = RI = 8), stage 1 4 FB FMAs for
//     1 + 2 FB / 4 loads;
//  4. the truncation is skipped: only the pairs n < extent[m] that the
//     triangular truncation keeps are copied and summed (the wrapper derives
//     extent once from the nonzero rows of cpol_inv, min(nx, trunc + 2 - m);
//     the kernel gets it by value, in the constant bank), so the input at
//     the other pairs is never read.

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
// launch (0 on success). spectral_synthesis_smem_bytes and
// spectral_analysis_smem_bytes give a launch's shared memory. The wrapper is
// speedy_tpu_torch/ops/fused_transforms.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
struct Extents {
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
                const __grid_constant__ Extents extent,
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

// Requests shared memory above the default once per kernel and device.
template <typename K>
int opt_in_smem(K kernel, unsigned& opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && !((opted_in >> dev) & 1u)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1u << dev;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Synthesis

constexpr int kSynThreads = 256;

// Output rows (field, latitude) per thread in stage 2: R = FB * TJ rows
// fall into R / RJ row groups of kSynThreads * RJ / R threads each, a
// multiple of the warp, so the threads of a warp share their rows.
__host__ __device__ constexpr int syn_rj(int r) { return r > 32 ? 8 : 4; }
__host__ __device__ constexpr int syn_tcn(int r) {
  return kSynThreads * syn_rj(r) / r;
}
// Longitudes per thread at most: 64 fp32 or 32 fp64 accumulators.
__host__ __device__ constexpr int syn_ri_max(int size, int r) {
  return (size == 4 ? 64 : 32) / syn_rj(r);
}
// Longitudes per thread (a template parameter: 1, 2, 3, 4, 8 or 16) for a
// block of ti longitudes: the fewest that cover ti, or 0 past syn_ri_max.
__host__ __device__ constexpr int syn_ri(int size, int r, int ti) {
  const int need = (ti + syn_tcn(r) - 1) / syn_tcn(r);
  const int ri = need <= 4 ? need : need <= 8 ? 8 : need <= 16 ? 16 : 0;
  return ri <= syn_ri_max(size, r) ? ri : 0;
}
// Values per vector load of a spectrum row (n; FB fields; r): a 16-byte
// vector, or one fp32 (re, im) pair at FB = 1.
__host__ __device__ constexpr int syn_sv(int size, int fb) {
  return 2 * fb < 16 / size ? 2 * fb : 16 / size;
}

// n values rounded up to the next count congruent to `to` modulo one
// cycle of the 32 banks, so that rows read at one column by one warp fall
// in distinct banks.
__host__ __device__ inline int bank_stride(int n, int to, int size) {
  const int w = 128 / size;
  return n + ((to - n) % w + w) % w;
}

// Shared-memory layout of one synthesis block, in values: fm [2 mc][R];
// the dft rows [2 mc][tip] (tip: ti padded to RI longitudes per thread,
// the pad zero); the cpol_inv slice [mc][cps] holding [n][TJ]; the spectra
// [mc][sps] holding [n][FB][r].
struct SynLayout {
  int tip, cps, sps, dft, cpol, spec, total;
};

__host__ __device__ inline SynLayout syn_layout(int fb, int tj, int ti,
                                                int mc, int nx, int size) {
  const int r = fb * tj;
  SynLayout l;
  l.tip = syn_ri(size, r, ti) * syn_tcn(r);
  l.cps = bank_stride(nx * tj, tj, size);
  l.sps = bank_stride(2 * nx * fb, syn_sv(size, fb), size);
  l.dft = 2 * mc * r;
  l.cpol = l.dft + 2 * mc * l.tip;
  l.spec = l.cpol + mc * l.cps;
  l.total = l.spec + mc * l.sps;
  return l;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copies of N bytes from device to shared memory (no
// registers held while in flight).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(N));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int FB, int TJ, int RI>
__global__ void __launch_bounds__(kSynThreads, 2)
synthesis_kernel(int batch, int mx, int nx, int il, int ix, int ti, int mc,
                 const T* __restrict__ spec, const T* __restrict__ cpol,
                 const T* __restrict__ dft,
                 const __grid_constant__ Extents extent,
                 T* __restrict__ grid) {
  using V = typename Vec16<T>::V;
  using P = typename Vec16<T>::P;
  constexpr int VN = Vec16<T>::kN;
  constexpr int R = FB * TJ;                   // output rows of the block
  constexpr int RJ = syn_rj(R);                // stage 2: rows per thread
  constexpr int TCN = syn_tcn(R);              // threads per row group
  constexpr int SV = syn_sv(sizeof(T), FB);
  constexpr int TJV = TJ / VN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SynLayout lay = syn_layout(FB, TJ, ti, mc, nx, sizeof(T));
  T* fm_s = reinterpret_cast<T*>(smem_raw);    // [2 mc][R]
  T* dft_s = fm_s + lay.dft;                   // [2 mc][tip]
  T* cpol_s = fm_s + lay.cpol;                 // [mc][cps]
  T* spec_s = fm_s + lay.spec;                 // [mc][sps]

  const int tid = threadIdx.x;
  const int n_ct = ix / ti, n_jt = il / TJ;
  const int ct = blockIdx.x % n_ct;
  const int j0 = (blockIdx.x / n_ct % n_jt) * TJ;
  const int b0 = blockIdx.x / (n_ct * n_jt) * FB;
  const int nf = min(FB, batch - b0);
  const int c0 = ct * ti;
  const int pad = lay.tip - ti;

  // the pad longitudes of the dft rows are zero (never copied over)
  for (int idx = tid; idx < 2 * mc * pad; idx += kSynThreads) {
    const int k = idx / pad;
    dft_s[k * lay.tip + ti + idx - k * pad] = T(0);
  }

  // stage 2's thread: rows rg*RJ .. +RJ, longitudes tc + c*TCN (c < RI)
  const int rg = tid / TCN, tc = tid % TCN;
  T acc[RJ][RI];
#pragma unroll
  for (int q = 0; q < RJ; ++q) {
#pragma unroll
    for (int c = 0; c < RI; ++c) acc[q][c] = T(0);
  }

  for (int m0 = 0; m0 < mx; m0 += mc) {
    const int nm = min(mc, mx - m0);
    // the m = 0 sine row of the DFT is zero: neither staged nor summed, so
    // the chunk's (m, r) rows k map to mr = 2 m0 + k (+1 past k = 0)
    const int drop = m0 == 0;
    const int nrows = 2 * nm - drop;

    // group 0: the chunk's cpol_inv rows and spectra, n < extent only; a
    // warp per wavenumber, so that every lane starts a copy (the copies
    // start at the rate L2 delivers, ~20 bytes a cycle per SM)
    for (int a = tid / 32; a < nm; a += kSynThreads / 32) {
      const int e = extent.n[m0 + a];
      const T* cp = cpol + (int64_t)(m0 + a) * nx * il + j0;
      T* cs = cpol_s + a * lay.cps;
      for (int idx = tid % 32; idx < e * TJV; idx += 32) {
        const int n = idx / TJV, v = idx % TJV;
        cp_async<16>(cs + n * TJ + v * VN, cp + (int64_t)n * il + v * VN);
      }
      const T* sp = spec + ((int64_t)b0 * mx + m0 + a) * nx * 2;
      T* ss = spec_s + a * lay.sps;
      for (int idx = tid % 32; idx < e * FB; idx += 32) {
        const int n = idx / FB, f = idx % FB;
        if (f < nf) {
          cp_async<(int)sizeof(P)>(ss + 2 * idx,
                                   sp + ((int64_t)f * mx * nx + n) * 2);
        } else {
          reinterpret_cast<P*>(ss)[idx] = Vec16<T>::pair(0, 0);
        }
      }
    }
    cp_async_commit();
    // group 1: the chunk's dft rows, in flight during stage 1
    {
      const int tiv = ti / VN;
      for (int idx = tid; idx < nrows * tiv; idx += kSynThreads) {
        const int k = idx / tiv, v = idx - k * tiv;
        const int mr = 2 * m0 + k + (drop && k > 0);
        cp_async<16>(dft_s + k * lay.tip + v * VN,
                     dft + (int64_t)mr * ix + c0 + v * VN);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // stage 1: Legendre sums. Item (a, jj) sums over n < extent the
    // latitudes 2 jj, 2 jj + 1 of wavenumber m0 + a for all FB fields and
    // both r: each pair of cpol_inv values it reads serves 4 FB outputs,
    // and the FB spectra at n come in 2 FB / SV vector loads (a
    // broadcast). Where the chunk has few items, S = 2^ls adjacent lanes
    // split an item's n and join their sums by a fixed butterfly.
    {
      const int n_items = nm * (TJ / 2);
      int ls = 0;
      while (ls < 2 && n_items << (ls + 1) <= kSynThreads) ++ls;
      const int S = 1 << ls;
      for (int base = tid & ~31; base < n_items << ls; base += kSynThreads) {
        const int it = (base | (tid & 31)) >> ls, h = tid & (S - 1);
        const bool on = it < n_items;
        const int jj = it % (TJ / 2), a = on ? it / (TJ / 2) : 0;
        const int e = on ? extent.n[m0 + a] : 0;
        const P* cs = reinterpret_cast<const P*>(cpol_s + a * lay.cps) + jj;
        const T* ss = spec_s + a * lay.sps;
        T s[2][2 * FB];
#pragma unroll
        for (int q = 0; q < 2 * FB; ++q) s[0][q] = s[1][q] = T(0);
#pragma unroll 2
        for (int n = h; n < e; n += S) {
          const P c = cs[n * (TJ / 2)];
#pragma unroll
          for (int q = 0; q < 2 * FB; q += SV) {
            T x[SV];
            if constexpr (SV == 2) {
              const P v = *reinterpret_cast<const P*>(ss + n * 2 * FB + q);
              x[0] = v.x;
              x[1] = v.y;
            } else {
              const V v = *reinterpret_cast<const V*>(ss + n * 2 * FB + q);
#pragma unroll
              for (int e2 = 0; e2 < SV; ++e2) x[e2] = comp(v, e2);
            }
#pragma unroll
            for (int e2 = 0; e2 < SV; ++e2) {
              s[0][q + e2] += x[e2] * c.x;
              s[1][q + e2] += x[e2] * c.y;
            }
          }
        }
        for (int o = 1; o < S; o <<= 1) {
#pragma unroll
          for (int q = 0; q < 2 * FB; ++q) {
            s[0][q] += __shfl_xor_sync(0xffffffffu, s[0][q], o);
            s[1][q] += __shfl_xor_sync(0xffffffffu, s[1][q], o);
          }
        }
        if (on && h == 0) {
#pragma unroll
          for (int f = 0; f < FB; ++f) {
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              T* out = fm_s + f * TJ + 2 * jj + p;
              if (drop && a == 0) {
                out[0] = s[p][2 * f];
              } else {
                out[(2 * a - drop) * R] = s[p][2 * f];
                out[(2 * a + 1 - drop) * R] = s[p][2 * f + 1];
              }
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // stage 2: zonal DFT, acc[q][c] += fm[k][row q] * dft[k][longitude c],
    // every operand from shared memory (fm rows a broadcast)
    {
      const V* fm_v = reinterpret_cast<const V*>(fm_s) + rg * (RJ / VN);
      const T* d_s = dft_s + tc;
#pragma unroll 2
      for (int k = 0; k < nrows; ++k) {
        V fv[RJ / VN];
#pragma unroll
        for (int q = 0; q < RJ / VN; ++q) fv[q] = fm_v[k * (R / VN) + q];
        T d[RI];
#pragma unroll
        for (int c = 0; c < RI; ++c) d[c] = d_s[k * lay.tip + c * TCN];
#pragma unroll
        for (int q = 0; q < RJ; ++q) {
          const T x = comp(fv[q / VN], q % VN);
#pragma unroll
          for (int c = 0; c < RI; ++c) acc[q][c] += x * d[c];
        }
      }
    }
    __syncthreads();  // the chunk's buffers are read; the next one refills
  }

  // one store per output, longitudes fastest (coalesced)
#pragma unroll
  for (int q = 0; q < RJ; ++q) {
    const int row = rg * RJ + q;
    const int f = row / TJ, j = row % TJ;
    if (f < nf) {
      T* g = grid + ((int64_t)(b0 + f) * il + j0 + j) * ix + c0 + tc;
#pragma unroll
      for (int c = 0; c < RI; ++c) {
        if (tc + c * TCN < ti) g[c * TCN] = acc[q][c];
      }
    }
  }
}

inline size_t syn_smem_bytes(int fp64, int fb, int tj, int ti, int mc,
                             int nx) {
  const int size = fp64 ? 8 : 4;
  return (size_t)size * syn_layout(fb, tj, ti, mc, nx, size).total;
}

template <typename T, int FB, int TJ, int RI>
int launch_synthesis(int blocks, size_t smem, int batch, int mx, int nx,
                     int il, int ix, int ti, int mc, const void* spec,
                     const void* cpol, const void* dft, const Extents& ext,
                     void* grid, cudaStream_t stream) {
  if constexpr (RI > syn_ri_max(sizeof(T), FB * TJ)) {
    return (int)cudaErrorInvalidValue;
  } else {
    static unsigned opted_in = 0;  // devices where the opt-in was made
    const int err = opt_in_smem(synthesis_kernel<T, FB, TJ, RI>, opted_in);
    if (err) return err;
    synthesis_kernel<T, FB, TJ, RI><<<blocks, kSynThreads, smem, stream>>>(
        batch, mx, nx, il, ix, ti, mc, static_cast<const T*>(spec),
        static_cast<const T*>(cpol), static_cast<const T*>(dft), ext,
        static_cast<T*>(grid));
    return (int)cudaGetLastError();
  }
}

template <typename T, int FB, int TJ>
int launch_synthesis(int batch, int mx, int nx, int il, int ix, int ti,
                     int mc, const void* spec, const void* cpol,
                     const void* dft, const int* extent, void* grid,
                     cudaStream_t stream) {
  constexpr int VN = Vec16<T>::kN;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(spec) | reinterpret_cast<uintptr_t>(dft) |
        reinterpret_cast<uintptr_t>(cpol)) & 15) == 0;
  const int ri = ti > 0 ? syn_ri(sizeof(T), FB * TJ, ti) : 0;
  if (!aligned || mx > kMaxM || il % TJ || ri == 0 || ix % ti || ti % VN ||
      mc <= 0 || mc > mx) {
    return (int)cudaErrorInvalidValue;
  }
  Extents ext = {};
  for (int m = 0; m < mx; ++m) ext.n[m] = extent[m];
  const size_t smem = syn_smem_bytes(sizeof(T) == 8, FB, TJ, ti, mc, nx);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int blocks = ((batch + FB - 1) / FB) * (il / TJ) * (ix / ti);
#define SYN_RI_CASE(N)                                                     \
  case N:                                                                  \
    return launch_synthesis<T, FB, TJ, N>(blocks, smem, batch, mx, nx, il, \
                                          ix, ti, mc, spec, cpol, dft, ext, \
                                          grid, stream);
  switch (ri) {
    SYN_RI_CASE(1) SYN_RI_CASE(2) SYN_RI_CASE(3) SYN_RI_CASE(4)
    SYN_RI_CASE(8) SYN_RI_CASE(16)
  }
#undef SYN_RI_CASE
  return (int)cudaErrorInvalidValue;
}

// The (FB, TJ) tiles the synthesis kernel is built for, in fp32 and fp64:
// those the wrapper picks. Its SYN_BUILT_TILES lists the same.
#define SYN_TILES_F32(X) X(1, 8) X(2, 8) X(2, 16) X(4, 16)
#define SYN_TILES_F64(X) X(2, 8) X(2, 16)

template <typename T>
int dispatch_synthesis(int fb, int tj, int batch, int mx, int nx, int il,
                       int ix, int ti, int mc, const void* spec,
                       const void* cpol, const void* dft, const int* extent,
                       void* grid, cudaStream_t stream) {
#define SYN_CASE(F, J)                                                      \
  if (fb == F && tj == J) {                                                 \
    return launch_synthesis<T, F, J>(batch, mx, nx, il, ix, ti, mc, spec,   \
                                     cpol, dft, extent, grid, stream);      \
  }
  if constexpr (sizeof(T) == 4) {
    SYN_TILES_F32(SYN_CASE)
  } else {
    SYN_TILES_F64(SYN_CASE)
  }
#undef SYN_CASE
  return (int)cudaErrorInvalidValue;
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
  Extents ext = {};
  for (int m = 0; m < mx; ++m) ext.n[m] = extent[m];
  const size_t smem =
      ana_smem_bytes(sizeof(T) == 8, FB, TM, il, ix, jc, nc, early);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static unsigned opted_in = 0;  // devices where the opt-in was made
  const int err = opt_in_smem(analysis_kernel<T, FB, TM>, opted_in);
  if (err) return err;
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
                                         int il, int ix, int fb, int tj,
                                         int ti, int mc, const void* spec,
                                         const void* cpol_inv,
                                         const void* dft_syn,
                                         const int* extent, void* grid,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp64 ? dispatch_synthesis<double>(fb, tj, batch, mx, nx, il, ix, ti,
                                           mc, spec, cpol_inv, dft_syn,
                                           extent, grid, s)
              : dispatch_synthesis<float>(fb, tj, batch, mx, nx, il, ix, ti,
                                          mc, spec, cpol_inv, dft_syn,
                                          extent, grid, s);
}

extern "C" long long spectral_synthesis_smem_bytes(int fp64, int fb, int tj,
                                                   int ti, int mc, int nx) {
  return (long long)syn_smem_bytes(fp64, fb, tj, ti, mc, nx);
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
