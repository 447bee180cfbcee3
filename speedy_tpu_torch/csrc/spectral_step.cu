// The step's spectral update for Hopper (sm_90a): what
// models/time_stepping.py step does after get_tendencies returns
// (time_stepping.f90:62-121), for every spectral element of every member,
// field and level, in one launch.
//
// Replaces: no TPU kernel. The JAX package leaves this chain to XLA, which
// fuses it; eagerly it was ~104 PyTorch launches a step (the Robert-
// Williams leapfrog 70, the diffusion 21, the drag, the orographic
// corrections and the tracer copy 13). Its plain PyTorch twin is
// speedy_tpu_torch.models.time_stepping.spectral_update_plain; the wrapper
// is spectral_update in the same module.
//
// Per element, in the twin's order, each multiply, add and subtract
// rounded on its own (the __*_rn intrinsics; the library is also built with
// -fmad=false), so the result is bit-equal to the twin's separate PyTorch
// operations:
//  1. vorticity and divergence: del^8 diffusion (dmp/dmp1, dmpd/dmp1d);
//     temperature: the same through t + tcorh * tcorv;
//  2. the stratospheric drag, -sdrag * field added at level 0, m = 0;
//  3. the del^2 stratospheric diffusion (dmps/dmp1s) of the three;
//  4. tracer 0 (humidity): del^8 through q + qcorh * qcorv with the
//     divergence coefficients (the reference's quirk, time_stepping.f90:96);
//     the other tracers are not diffused;
//  5. the triangular truncation (trfilt) when the wrapper asks for it;
//  6. the filtered leapfrog: fnew = fnow + dt*fdt, then both time levels.
// The scalars (dt, wil*eps, (1-wil)*eps, -sdrag) arrive in double, computed
// on the host as the twin's Python floats, and are rounded to the working
// type as PyTorch rounds a Python scalar.
//
// What bounds it: bytes. An element reads its two time levels and its
// tendency (the [mx, nx] tables and the corrections stay in cache) and
// writes two values: 20 bytes in fp32, ~38 MB a step at T170 (1.94 M
// elements), ~1.3 MB at T30, 84 MB at T30 with 64 members. The arithmetic
// is ~20 operations an element.
//
// Design: one thread an element, elements in the output's order (members,
// then the fields' rows, then m, n, re/im), so the state's and the outputs'
// accesses are coalesced. Each input is read through its own element
// strides: the tendencies are strided views of the analysis and vdspec
// outputs (divergence with the level axis inside (m, n), members inner),
// and copying them contiguous first would cost launches. A row (one level
// of one field, mx*nx*2 elements) belongs to one field, so a warp takes one
// branch of the field switch but at the rows' seams. The block plan
// depends only on the element count.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 5;
enum Field { VOR = 0, DIV = 1, TEM = 2, PS = 3, TR = 4 };

// One prognostic field: its state [M, 2, sub, lev, mx, nx, 2] read at the
// element strides ns, its tendency [M, sub, lev, mx, nx, 2] at ts (a
// missing axis has stride 0), and its output in the state's layout,
// contiguous. sub is the tracer count for TR, else 1; its rows (sub x lev)
// start at row0 among all fields' rows.
template <typename T>
struct FieldArgs {
  const T* now;
  const T* tend;
  T* out;
  long long ns[7];
  long long ts[6];
  int lev, rows, row0;
};

template <typename T>
struct SpectralStepArgs {
  FieldArgs<T> f[kFields];
  const T* tcorh;       // [M, mx, nx, 2] at strides tcs
  const T* qcorh;       // [M, mx, nx, 2] at strides qcs
  long long tcs[4], qcs[4];
  const T *dmp, *dmpd, *dmps, *dmp1, *dmp1d, *dmp1s, *trfilt;  // [mx, nx]
  const T *tcorv, *qcorv;                                        // [kx]
  T dt, wa, wb, nsdrag;  // dt, wil*eps, (1-wil)*eps, -sdrag
  int rows, mx, nx, j1, trunc;
  unsigned total;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// (fdt - dmp*x) * dmp1 (horizontal_diffusion.f90:86-105)
template <typename T>
__device__ __forceinline__ T diffuse(T fdt, T x, T dmp, T dmp1) {
  return mul(sub(fdt, mul(dmp, x)), dmp1);
}

template <typename T, int F>
__device__ __forceinline__ void update(const SpectralStepArgs<T>& a,
                                       unsigned b, unsigned row, unsigned e,
                                       unsigned s) {
  const FieldArgs<T>& f = a.f[F];
  const int r = static_cast<int>(row) - f.row0;
  const int tracer = r / f.lev, k = r % f.lev;
  const int c = e & 1, n = (e >> 1) % a.nx, m = (e >> 1) / a.nx;
  const int mn = m * a.nx + n;
  const long long so = b * f.ns[0] + tracer * f.ns[2] + k * f.ns[3] +
                       m * f.ns[4] + n * f.ns[5] + c * f.ns[6];
  const T fnow = f.now[so];
  const T fold = f.now[so + (a.j1 - 1) * f.ns[1]];
  T d = f.tend[b * f.ts[0] + tracer * f.ts[1] + k * f.ts[2] + m * f.ts[3] +
               n * f.ts[4] + c * f.ts[5]];
  if (F == VOR || F == DIV) {
    d = F == VOR ? diffuse(d, fnow, a.dmp[mn], a.dmp1[mn])
                 : diffuse(d, fnow, a.dmpd[mn], a.dmp1d[mn]);
    if (k == 0 && m == 0) d = add(d, mul(a.nsdrag, fnow));
    d = diffuse(d, fnow, a.dmps[mn], a.dmp1s[mn]);
  } else if (F == TEM) {
    const T x = add(fnow, mul(a.tcorh[b * a.tcs[0] + m * a.tcs[1] +
                                      n * a.tcs[2] + c * a.tcs[3]],
                              a.tcorv[k]));
    d = diffuse(d, x, a.dmp[mn], a.dmp1[mn]);
    d = diffuse(d, x, a.dmps[mn], a.dmp1s[mn]);
  } else if (F == TR) {
    if (tracer == 0) {
      const T x = add(fnow, mul(a.qcorh[b * a.qcs[0] + m * a.qcs[1] +
                                        n * a.qcs[2] + c * a.qcs[3]],
                                a.qcorv[k]));
      d = diffuse(d, x, a.dmpd[mn], a.dmp1d[mn]);
    }
  }
  if (a.trunc) d = mul(d, a.trfilt[mn]);
  // time_stepping.f90:142-167
  const T two = T(2);
  const T fnew = add(fnow, mul(a.dt, d));
  const T f1 = add(fold, mul(a.wa, add(sub(fnow, mul(two, fold)), fnew)));
  const T f2 = sub(fnew, mul(a.wb, add(sub(f1, mul(two, fold)), fnew)));
  const long long o =
      (static_cast<long long>(b) * 2 * f.rows + r) * s + e;
  f.out[o] = f1;
  f.out[o + static_cast<long long>(f.rows) * s] = f2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spectral_step_elementwise_kernel(const SpectralStepArgs<T> a) {
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= a.total) return;
  const unsigned s = static_cast<unsigned>(a.mx) * a.nx * 2;
  const unsigned e = g % s, q = g / s;
  const unsigned row = q % a.rows, b = q / a.rows;
  if (row < static_cast<unsigned>(a.f[DIV].row0))
    update<T, VOR>(a, b, row, e, s);
  else if (row < static_cast<unsigned>(a.f[TEM].row0))
    update<T, DIV>(a, b, row, e, s);
  else if (row < static_cast<unsigned>(a.f[PS].row0))
    update<T, TEM>(a, b, row, e, s);
  else if (row < static_cast<unsigned>(a.f[TR].row0))
    update<T, PS>(a, b, row, e, s);
  else
    update<T, TR>(a, b, row, e, s);
}

template <typename T>
cudaError_t launch(const int* dims, const void* const* ptrs,
                   const long long* strides, const double* scalars,
                   cudaStream_t stream) {
  SpectralStepArgs<T> a;
  const int members = dims[0], kx = dims[1], ntr = dims[2];
  a.mx = dims[3];
  a.nx = dims[4];
  a.j1 = dims[5];
  a.trunc = dims[6];
  if (members < 1 || kx < 1 || ntr < 1 || a.mx < 1 || a.nx < 1 ||
      (a.j1 != 1 && a.j1 != 2))
    return cudaErrorInvalidValue;
  const int subs[kFields] = {1, 1, 1, 1, ntr};
  const int levs[kFields] = {kx, kx, kx, 1, kx};
  int row0 = 0;
  for (int i = 0; i < kFields; ++i) {
    FieldArgs<T>& f = a.f[i];
    f.now = static_cast<const T*>(ptrs[i]);
    f.tend = static_cast<const T*>(ptrs[kFields + i]);
    f.out = static_cast<T*>(const_cast<void*>(ptrs[2 * kFields + i]));
    for (int j = 0; j < 7; ++j) f.ns[j] = strides[13 * i + j];
    for (int j = 0; j < 6; ++j) f.ts[j] = strides[13 * i + 7 + j];
    f.lev = levs[i];
    f.rows = subs[i] * levs[i];
    f.row0 = row0;
    row0 += f.rows;
  }
  const void* const* tab = ptrs + 3 * kFields;
  a.tcorh = static_cast<const T*>(tab[0]);
  a.qcorh = static_cast<const T*>(tab[1]);
  for (int j = 0; j < 4; ++j) {
    a.tcs[j] = strides[13 * kFields + j];
    a.qcs[j] = strides[13 * kFields + 4 + j];
  }
  a.dmp = static_cast<const T*>(tab[2]);
  a.dmpd = static_cast<const T*>(tab[3]);
  a.dmps = static_cast<const T*>(tab[4]);
  a.dmp1 = static_cast<const T*>(tab[5]);
  a.dmp1d = static_cast<const T*>(tab[6]);
  a.dmp1s = static_cast<const T*>(tab[7]);
  a.trfilt = static_cast<const T*>(tab[8]);
  a.tcorv = static_cast<const T*>(tab[9]);
  a.qcorv = static_cast<const T*>(tab[10]);
  a.dt = static_cast<T>(scalars[0]);
  a.wa = static_cast<T>(scalars[1]);
  a.wb = static_cast<T>(scalars[2]);
  a.nsdrag = static_cast<T>(scalars[3]);
  a.rows = row0;
  const long long total =
      static_cast<long long>(members) * row0 * a.mx * a.nx * 2;
  if (total > INT_MAX) return cudaErrorInvalidValue;
  a.total = static_cast<unsigned>(total);
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  spectral_step_elementwise_kernel<T><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C interface. dims: members, kx, ntr, mx, nx, j1, trunc (1: apply trfilt);
// ptrs: 26 device pointers, the states of vor, div, t, ps, tr, their
// tendencies in the same order, their outputs, then tcorh, qcorh, dmp,
// dmpd, dmps, dmp1, dmp1d, dmp1s, trfilt, tcorv, qcorv; strides: 73
// element strides, for each field its state's 7 (member, time level,
// tracer, level, m, n, re/im) and its tendency's 6 (the same without the
// time level), then tcorh's and qcorh's 4 (member, m, n, re/im); a missing
// or shared axis has stride 0; scalars: dt, wil*eps, (1-wil)*eps, -sdrag.
// The outputs are [members, 2, ...] in the state's layout, contiguous.
// Returns the cudaError_t of the launch (0 on success). Does not
// synchronise.
extern "C" int spectral_step_launch(int f64, const int* dims,
                                    const void* const* ptrs,
                                    const long long* strides,
                                    const double* scalars, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = f64 ? launch<double>(dims, ptrs, strides, scalars, st)
                        : launch<float>(dims, ptrs, strides, scalars, st);
  return static_cast<int>(err);
}
