// Column physics for Hopper (sm_90a): the whole grid-point physics chain of
// the model in one kernel, a block of 32 (lat, lon) columns x 8 lanes.
//
// Replaces: the Pallas TPU kernel
//   speedy_tpu/models/physics/fused.py::fused_grid_physics (body _kernel),
// which ran speedy_tpu.models.physics.grid_physics_core on latitude tiles.
// Its plain PyTorch twin is speedy_tpu_torch.models.physics.grid_physics_core;
// the wrapper is speedy_tpu_torch/models/physics/fused.py.
//
// Chain per column: humidity -> convection -> large-scale condensation ->
// [clouds + shortwave fluxes + LW transmissivities, SW steps only] -> LW
// down -> surface fluxes and land skin temperature -> LW up -> vertical
// diffusion, with the surface fluxes injected at level kx.
//
// What bounds it: bytes, at every preset. A call reads 3 [kx] fields, the
// lowest-level winds, 11 surface fields and (non-SW steps) the carried
// radiation state, and writes 21 (27 on SW steps) outputs: about 568
// bytes a column in fp32 (kx=8), 0.78 us at T30 (4,608 columns), 5.6 us at
// T85 (32,768) and 22 us at T170 (131,072) at 3.35 TB/s, twice that in
// fp64. The arithmetic is a few thousand operations a column, well below
// the card's rate. What the kernel actually waits on is latency: the
// chain of dependent steps through a column (exp, division, the sweeps).
//
// Design. The first version ran one thread per column, the whole chain as
// one serial thread: at T30 36 blocks on 132 SMs, and in fp64 its 4*kx
// transmissivities per thread spilled at 255 registers. Here a block takes
// 32 columns and 256 threads, and the chain runs in phases separated by
// barriers, each with the thread layout that suits it:
//  - Staging: each input row (one level of a field) of the block's 32
//    columns is one coalesced warp load into shared memory, with the [il]
//    fields and ablco2 gathered at each column; the outputs are gathered
//    there and stored the same way. Plain loads: a block moves ~19 KB (fp32)
//    or ~38 KB (fp64), too little for TMA or cp.async pipelines to pay.
//  - Level work (a team of 8 lanes per column, one lane per level; lanes
//    at or above kx idle): humidity and qsat, the condensation test, the
//    band fractions and st4a terms, the SW and LW transmissivities with
//    their exps, and vertical diffusion. The level tables are copied to
//    shared memory once: read from the parameter bank with a lane's level
//    as index, a warp's 8 addresses would serialise.
//  - Sweeps and column scalars (one walker lane per column, 32 to a warp):
//    convection's mass-flux sweep, condensation's sum, clouds, the SW
//    passes, the LW down and up sweeps and the surface fluxes stay serial
//    in the plain chain's order, reading each level's coefficients from
//    shared memory. Packing the walkers 32 to a warp keeps a sweep at one
//    instruction per 32 columns; a walker per team would pay 8x the issue
//    slots. Two walker warps run independent sweeps side by side (LW down
//    beside convection on non-SW steps, beside the SW passes on SW steps).
//    The sweeps are unrolled: rolled, each step waits on its own
//    shared-memory loads (measured 1.3x slower at T30).
// Every sum keeps the plain chain's order, and the library is built
// without FMA contraction (fused.NVCC_FLAGS), so each multiply and add
// rounds as the plain chain's separate operations do: fp64 agrees to
// rounding and no fp32 threshold test falls the other way.
// What it gains and what it costs: fp64 fits 80 registers (three blocks
// an SM) with a few dozen bytes of spills where the first version spilled
// ~800. But the first version's unrolled level loops already overlapped
// the levels' independent chains, so a lane per level does not shorten a
// phase: it waits on its longest chain, and the walkers' sweeps are as
// long as before. At T30 a block takes about as long as a thread did; with
// 8 threads and 1.1-2.3 KB of shared memory a column, an SM holds 96-128
// columns in flight against the first version's 256, which makes T85 and
// T170, where the card is full, slower. PERF.md has the numbers.
// Shared memory is one row of 32 values (+16 bytes against bank
// conflicts) per staged input, output and work row: 36-40 KB in fp32,
// 68-75 KB in fp64 at kx=8 (opted in above 48 KB). Templates cover
// fp32/fp64, kx in {5, 7, 8}, the SW / non-SW variants and the two LW
// orders.
//
// The two LW orders. grid_physics_core takes the band-vectorized LW sweeps
// (longwave.py *_vec, the default) or, with lw_band_vectorized=False, the
// reference-order pair (downward_longwave, upward_longwave), which adds each
// band's +f and -f_new into a level's absorbed flux one after another
// instead of adding the four bands' sum. The sums round differently, and the
// JAX package found the difference to change the 90-day stability at T85, so
// the option is a variant of its own: the REFLW instantiations keep a
// walker's per-level accumulators in registers (kx <= 8, unrolled) and add
// in the reference's order. Only the two LW walker phases differ, through
// `if constexpr`: the default instantiations are the code they were.
//
// Ensembles. The JAX package vmaps the Pallas call over an ensemble's
// members. Here the members are extra columns of one launch: the grid's
// second dimension is the member, so a block's 32 columns belong to one
// member and its column indices are those of a one-model launch. Each
// input row is read at its own member stride, 0 for what all members share
// (orography, masks, the date's [il] fields and ablco2, or a field
// expanded over the members), so a shared row is not copied M times; each
// output row is [M, ...], member-major. Every column runs the same code
// whatever its member, so a member's outputs are those of a one-member
// launch on its inputs. The member strides ride in MemberParams, and only
// the MEMBERS instantiations read them: with them in every launch's
// parameters, one model's launch was measured 3-16% slower (PERF.md), so
// one model keeps the kernel it had.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (no fast-math), loaded with ctypes through column_physics_launch() below.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int MAXL = 9;       // slots per level table (kx + 1 at most)
constexpr int N_IN = 27;      // kernel inputs (non-SW steps)
constexpr int N_IN_SW = 23;   // kernel inputs on SW steps
constexpr int N_OUT = 27;     // outputs on SW steps
constexpr int N_OUT_NOSW = 21;
constexpr int N_LAT = 7;      // the [il] fields and ablco2: inputs 16-22

constexpr int kCols = 32;                 // columns per block
constexpr int kLanes = 8;                 // lanes per column, one per level
constexpr int kThreads = kCols * kLanes;  // 256
constexpr int kStaticSmem = 48 * 1024;    // without an opt-in
constexpr int kMaxSmem = 232448;          // 227 KB, an H100 block's most

// physical constants (speedy_tpu_torch/constants.py)
constexpr double CP = 1004.0;
constexpr double AKAP = 2.0 / 7.0;
constexpr double RGAS = AKAP * CP;
constexpr double ALHC = 2501.0;
constexpr double SBC = 5.67e-8;
constexpr double P0 = 1.0e5;
// convection.py
constexpr double PSMIN = 0.8, RHBL = 0.9, RHIL = 0.7, SMF = 0.8, FQMAX = 5.0;
// condensation.py
constexpr double RTLSC = 1.0 / (4.0 * 3600.0);
// shortwave.py
constexpr double RHCL1 = 0.30, RHCL2 = 1.00, QACL = 0.20, WPCL = 0.2,
                 PMAXCL = 10.0, CLSMAX = 0.60, CLSMINL = 0.15,
                 GSE_S0 = 0.25, GSE_S1 = 0.40, ALBCL = 0.43, ALBCLS = 0.50,
                 ABSDRY = 0.033, ABSWV1 = 0.022, ABSWV2 = 15.0,
                 ABSCL1 = 0.015, ABSCL2 = 0.15, ABLWIN = 0.3, ABLWV1 = 0.7,
                 ABLWV2 = 50.0, ABLCL1 = 12.0, ABLCL2 = 0.6, EPSLW = 0.05,
                 EMISFC = 0.98;
// surface.py
constexpr double FWIND0 = 0.95, FTEMP0 = 1.0, CDL = 2.4e-3, CDS = 1.0e-3,
                 CHL = 1.2e-3, CHS = 0.9e-3, VGUST = 5.0, CTDAY = 1.0e-2,
                 DTHETA = 3.0, FSTAB = 0.67, CLAMBDA = 7.0, CLAMBSN = 7.0;
// vertical_diffusion.py
constexpr double REDSHC = 0.5, SEGRAD = 0.1;

// Level tables and scalars, in the order of fused.argument_block.
constexpr int N_TABLES = 15;
enum Table { FSG, DHS, SIGH, WVI2, GRDSIG, GRDSCP, ENTR, RHREF, DQMAX, ABS1,
             RSIG, RSIG1, LSCP, FVDIQ2, DRH0 };
template <typename T>
struct ColumnTables {
  T tab[N_TABLES][MAXL];
  T fm0, t1s_den, eps1, fshcq, fshcse, fvdise;
  int vdif_mask;  // bit k set: moisture diffusion at 1-based level k
};

// Rows of shared memory, each kCols values of one level of one field, for
// the block's staged inputs, then its outputs, then the work rows that
// carry values from one phase to the next. fused.block_plan mirrors the
// counts.
template <int KX, bool SW>
struct Layout {
  // inputs, in fused.kernel_inputs order; SFC holds the 11 [il, ix]
  // fields pslg albsfc alb_l alb_s snowc soilw_am stl_am sst_am forog
  // phis0 fmask_l; the carried radiation state only on non-SW steps
  static constexpr int UA = 0, VA = 1, TG = 2, QG = TG + KX, PHI = QG + KX,
      SFC = PHI + KX, TAU2_IN = SFC + 11, STRATC_IN = TAU2_IN + 4 * KX,
      TTRSW_IN = STRATC_IN + 2, SSRD_IN = TTRSW_IN + KX,
      N_IN_ROWS = SW ? TAU2_IN : SSRD_IN + 1;
  // outputs, in fused.output_shapes order (USTR..SLRU: land, sea, mean)
  static constexpr int OUT = N_IN_ROWS, UTEND = OUT, VTEND = UTEND + KX,
      TTEND = VTEND + KX, QTEND = TTEND + KX, PRECNV = QTEND + KX,
      PRECLS = PRECNV + 1, CBMF = PRECLS + 1, SLRD = CBMF + 1,
      SLR = SLRD + 1, OLR = SLR + 1, USTR = OLR + 1, VSTR = USTR + 3,
      SHF = VSTR + 3, EVAP = SHF + 3, SLRU = EVAP + 3, HFLUXN = SLRU + 3,
      TSFC = HFLUXN + 2, TSKIN = TSFC + 1, U0 = TSKIN + 1, V0 = U0 + 1,
      T0 = V0 + 1, TAU2 = T0 + 1, STRATC = TAU2 + 4 * KX,
      TTRSW = STRATC + 2, SSRD = TTRSW + KX, SSR = SSRD + 1, TSR = SSR + 1,
      N_OUT_ROWS = (SW ? TSR + 1 : TAU2) - OUT;
  // work rows: per level (se, qsat, rh, 4 band fractions, st4a1, st4a2,
  // the LW heating; on SW steps tau_1, tau_2, refl), then per column
  // (with the [il] fields and ablco2 at each column), then the level
  // tables (a lane reads its own level's entries from here)
  static constexpr int WORK = OUT + N_OUT_ROWS, SE = WORK, QSAT = SE + KX,
      RH = QSAT + KX, FB = RH + KX, ST4A1 = FB + 4 * KX, ST4A2 = ST4A1 + KX,
      LW = ST4A2 + KX, TAU1 = LW + KX, TAU2S = TAU1 + KX, REFL = TAU2S + KX,
      ICNV = SW ? REFL + KX : TAU1, ICLTOP = ICNV + 1, CLOUDC = ICLTOP + 1,
      CLSTR = CLOUDC + 1, FLUX = CLSTR + 1, LAT = FLUX + 4,
      TAB = LAT + N_LAT, ROWS = TAB + N_TABLES;
  // the transmissivities the LW sweeps read: computed (SW) or carried
  static constexpr int TAU2_LW = SW ? TAU2 : TAU2_IN;
};
constexpr int MAX_IN_ROWS = Layout<8, false>::N_IN_ROWS;
constexpr int MAX_OUT_ROWS = Layout<8, true>::N_OUT_ROWS;

// Shared-memory row pitch in values: kCols + 16 bytes, so that the 8
// levels of a team's 4 columns (fp32) or 2 columns (fp64, half-warps) fall
// in distinct banks.
template <typename T>
__host__ __device__ constexpr int pitch() {
  return kCols + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int KX, bool SW>
constexpr int smem_bytes() {
  return Layout<KX, SW>::ROWS * pitch<T>() * static_cast<int>(sizeof(T));
}

template <typename T>
struct Params {
  const void* in_rows[MAX_IN_ROWS];  // (member 0's) row of each staged input row
  void* out_rows[MAX_OUT_ROWS];      // (member 0's) row of each output row
  const T* lat[N_LAT];               // fsol ozupp ozone zenit stratz coa ablco2
  ColumnTables<T> c;
  int S, ix;                         // one member's columns (il*ix), longitudes
};

// An ensemble's launch: also the elements from one member's row to the next
template <typename T>
struct MemberParams : Params<T> {
  int in_mstride[MAX_IN_ROWS];
  int out_mstride[MAX_OUT_ROWS];
};

template <typename T, bool MEMBERS>
using ParamsOf = std::conditional_t<MEMBERS, MemberParams<T>, Params<T>>;

template <typename T>
struct Tile {
  T* sm;
  __device__ __forceinline__ T& operator()(int row, int col) const {
    return sm[row * pitch<T>() + col];
  }
};

template <typename T> __device__ __forceinline__ T mn(T a, T b) {
  return a < b ? a : b;
}
template <typename T> __device__ __forceinline__ T mx(T a, T b) {
  return a > b ? a : b;
}

// Saturation specific humidity, g/kg (humidity.py get_qsat): p = sig*psa.
template <typename T>
__device__ __forceinline__ T qsat_of(T ta, T sigpsa) {
  const T t0 = T(273.16);
  T es = ta >= t0 ? T(6.108e-3) * exp(T(17.269) * (ta - t0) / (ta - T(35.86)))
                  : T(6.108e-3) * exp(T(21.875) * (ta - t0) / (ta - T(7.66)));
  return T(622.0) * es / (sigpsa - T(0.378) * es);
}

// LW band fractions at nint(ta) (longwave.py _fband_at).
template <typename T>
__device__ __forceinline__ void fband(T ta, T f[4]) {
  T tq = floor(ta + T(0.5));
  tq = mn(mx(tq, T(200.0)), T(320.0));
  const T eps1 = T(1.0 - EPSLW);
  const T d1 = tq - T(247.0), d2 = tq - T(282.0), d3 = tq - T(315.0);
  f[1] = (T(0.148) - T(3.0e-6) * (d1 * d1)) * eps1;
  f[2] = (T(0.356) - T(5.2e-6) * (d2 * d2)) * eps1;
  f[3] = (T(0.314) + T(1.0e-5) * (d3 * d3)) * eps1;
  f[0] = eps1 - f[1] - f[2] - f[3];
}

template <typename T>
__device__ __forceinline__ T band_sum(const T f[4]) {
  return ((f[0] + f[1]) + f[2]) + f[3];
}

// ---- level phases: lane k of column col ----

// Humidity, the condensation test, band fractions and st4a terms of one
// level. Writes the level's qg (clamped at 0, in place), se, qsat, rh, fb
// and st4a rows; returns the condensation's tendencies through lsc_q/t.
template <typename T, int KX, bool SW>
__device__ __forceinline__ bool level_humidity(const ColumnTables<T>& c,
                                               Tile<T> at, int col, int k,
                                               T psg, T& lsc_q, T& lsc_t) {
  using L = Layout<KX, SW>;
  constexpr int nl1 = KX - 1;
  const T ta = at(L::TG + k, col);
  const T qa = mx(at(L::QG + k, col), T(0.0));
  const T se = T(CP) * ta + at(L::PHI + k, col);
  auto tab = [&](int t, int i) { return at(L::TAB + t, i); };
  const T qsat = qsat_of(ta, tab(FSG, k) * psg);
  at(L::QG + k, col) = qa;
  at(L::SE + k, col) = se;
  at(L::QSAT + k, col) = qsat;
  at(L::RH + k, col) = qa / qsat;

  // large-scale condensation (condensation.py), level 1 excluded
  bool lsc = false;
  if (k >= 1) {
    const T dqa = tab(RHREF, k) * qsat - qa;
    if (dqa < T(0.0)) {
      const T dq = dqa * T(RTLSC);
      const T psa2 = psg * psg;
      lsc = true;
      lsc_q = dq;
      lsc_t = T(ALHC / CP) * mn(-dq, tab(DQMAX, k) * psa2);
    }
  }

  // band fractions and st4a (longwave.py downward_longwave_vec)
  T fb[4];
  fband(ta, fb);
#pragma unroll
  for (int b = 0; b < 4; ++b) at(L::FB + b * KX + k, col) = fb[b];
  auto thalf = [&](int j) {
    const T a = at(L::TG + j, col);
    return a + tab(WVI2, j) * (at(L::TG + j + 1, col) - a);
  };
  T s2;
  if (k == 0) {
    s2 = T(0.75) * ta + T(0.25) * thalf(0);
  } else if (k == 1) {
    s2 = T(0.50) * ta + T(0.25) * (thalf(0) + thalf(1));
  } else if (k < nl1) {
    s2 = T(0.5) * mx(thalf(k) - thalf(k - 1), T(0.0));
  } else {
    s2 = mx(ta - thalf(nl1 - 1), T(0.0));
  }
  T s1;
  if (k < 2) {
    const T x2 = s2 * s2;
    s1 = T(SBC) * (x2 * x2);
    s2 = T(0.0);
  } else {
    const T st3a = T(SBC) * (ta * ta * ta);
    s1 = st3a * ta;
    s2 = T(4.0) * st3a * s2;
  }
  at(L::ST4A1 + k, col) = s1;
  at(L::ST4A2 + k, col) = s2;
  return lsc;
}

// SW transmissivities, cloud reflection and the LW transmissivities of one
// level (shortwave_rad_fluxes; shortwave_radiation.f90:190-228), after
// clouds. The quirks at levels 0 and kx-1 are the plain chain's.
template <typename T, int KX>
__device__ __forceinline__ void level_transmissivities(
    const ColumnTables<T>& c, Tile<T> at, int col, int k, T psg) {
  using L = Layout<KX, true>;
  constexpr int nl1 = KX - 1;
  const int icltop = static_cast<int>(at(L::ICLTOP, col));
  const T cloudc = at(L::CLOUDC, col);
  const T qa = at(L::QG + k, col);
  auto tab = [&](int t, int i) { return at(L::TAB + t, i); };
  const T dhs = tab(DHS, k);
  const T psaz = psg * at(L::LAT + 3, col);
  const T acloud = cloudc * mn(T(ABSCL1) * at(L::QG + nl1 - 1, col),
                               T(ABSCL2));
  T tau_1;
  if (k == 0) {
    tau_1 = exp(-psaz * c.tab[DHS][0] * T(ABSDRY));
  } else if (k == KX - 1) {
    tau_1 = exp(-psaz * c.tab[DHS][KX - 1] *
                (c.tab[ABS1][KX - 1] + T(ABSWV1) * qa));
  } else {
    const T a = (k + 1 >= icltop) ? acloud : T(0.0);
    tau_1 = exp(-psaz * dhs * (tab(ABS1, k) + T(ABSWV1) * qa + a));
  }
  at(L::TAU1 + k, col) = tau_1;
  at(L::TAU2S + k, col) = exp(-psaz * dhs * T(ABSWV2) * qa);
  T refl = (k + 1 == icltop) ? T(ALBCL) * cloudc : T(0.0);
  if (k == KX - 1) {
    const T clstr = at(L::CLSTR, col);
    refl += T(ALBCLS) * clstr;
    if (icltop == KX) refl = T(ALBCL) * cloudc * T(0.0) + T(ALBCLS) * clstr;
  }
  at(L::REFL + k, col) = refl;

  const T aclw = cloudc * T(ABLCL2);
  const T dp = psg * dhs;
  T lw1, lw3, lw4;
  if (k >= 2 && k <= KX - 2) {
    const T acl1 = (k + 1 < icltop) ? aclw : T(ABLCL1) * cloudc;
    lw1 = exp(-dp * (T(ABLWIN) + acl1));
    lw3 = exp(-dp * mx(T(ABLWV1) * qa, aclw));
    lw4 = exp(-dp * mx(T(ABLWV2) * qa, aclw));
  } else {
    lw1 = exp(-dp * T(ABLWIN));
    lw3 = k == 0 ? T(1.0) : exp(-dp * T(ABLWV1) * qa);
    lw4 = k == 0 ? T(1.0) : exp(-dp * T(ABLWV2) * qa);
  }
  at(L::TAU2 + k, col) = lw1;
  at(L::TAU2 + KX + k, col) = exp(-dp * at(L::LAT + 6, col));
  at(L::TAU2 + 2 * KX + k, col) = lw3;
  at(L::TAU2 + 3 * KX + k, col) = lw4;
}

// The level's temperature and moisture tendencies: convection (from the
// walker's dfse/dfqa), condensation, radiation, then vertical diffusion
// (vertical_diffusion.py, physics.f90:192-205) with the surface fluxes
// injected at level kx. Writes utend, vtend, ttend and qtend.
template <typename T, int KX, bool SW>
__device__ __forceinline__ void level_tendencies(const ColumnTables<T>& c,
                                                 Tile<T> at, int col, int k,
                                                 T rps, bool lsc, T lsc_q,
                                                 T lsc_t) {
  using L = Layout<KX, SW>;
  constexpr int nl1 = KX - 1;
  auto tab = [&](int t, int i) { return at(L::TAB + t, i); };
  T ttend = at(L::TTEND + k, col) * rps * tab(GRDSCP, k);
  T qtend = at(L::QTEND + k, col) * rps * tab(GRDSIG, k);
  if (lsc) {
    qtend += lsc_q;
    ttend += lsc_t;
  }
  const T tt_rsw = at((SW ? L::TTRSW : L::TTRSW_IN) + k, col);
  ttend = ttend + tt_rsw + at(L::LW + k, col);

  auto se = [&](int i) { return at(L::SE + i, col); };
  auto qs = [&](int i) { return at(L::QSAT + i, col); };
  auto rh = [&](int i) { return at(L::RH + i, col); };
  auto phig = [&](int i) { return at(L::PHI + i, col); };
  const int icnv = static_cast<int>(at(L::ICNV, col));
  T ttv = T(0.0), qtv = T(0.0);
  const T fcnv = icnv > 0 ? T(REDSHC) : T(1.0);
  const T dmse = se(KX - 1) - se(nl1 - 1) +
                 T(ALHC) * (at(L::QG + KX - 1, col) - qs(nl1 - 1));
  const T drh = rh(KX - 1) - rh(nl1 - 1);
  const bool unstable = dmse >= T(0.0);
  const T fluxse = unstable ? fcnv * c.fshcse * dmse : T(0.0);
  if (k == nl1 - 1) ttv += fluxse * c.tab[RSIG][nl1 - 1];
  if (k == KX - 1) ttv += -fluxse * c.tab[RSIG][KX - 1];
  const T fluxq_sc = (unstable && drh >= T(0.0))
                         ? fcnv * c.fshcq * qs(KX - 1) * drh : T(0.0);
  const T fluxq_st = (!unstable && drh > c.tab[DRH0][KX - 2])
                         ? c.tab[FVDIQ2][nl1] * qs(nl1 - 1) * drh : T(0.0);
  const T fluxq = fluxq_sc + fluxq_st;
  if (k == nl1 - 1) qtv += fluxq * c.tab[RSIG][nl1 - 1];
  if (k == KX - 1) qtv += -fluxq * c.tab[RSIG][KX - 1];
  // moisture diffusion between levels k0 and k0 + 1, 1-based k0 + 1 in
  // [3, kx - 2] where its mask bit is set: this level is k0 + 1, then k0
  auto fq = [&](int k0, T& v) {
    const int kk = k0 + 1;
    if (kk < 3 || kk >= KX - 1 || !((c.vdif_mask >> kk) & 1)) return false;
    const T d = rh(k0 + 1) - rh(k0);
    if (!(d >= tab(DRH0, k0))) return false;
    v = tab(FVDIQ2, kk) * qs(k0) * d;
    return true;
  };
  T f;
  if (k >= 1 && fq(k - 1, f)) qtv += -f * tab(RSIG, k);
  if (fq(k, f)) qtv += f * tab(RSIG, k);
  // dry static energy: level k0 heats itself and cools every level below
  // it, in the order of k0
#pragma unroll
  for (int k0 = 0; k0 < KX - 1; ++k0) {
    if (k0 > k) break;
    const T se0 = se(k0 + 1) + T(SEGRAD) * (phig(k0) - phig(k0 + 1));
    if (se(k0) < se0) {
      const T fse = c.fvdise * (se0 - se(k0));
      if (k0 == k) ttv += fse * c.tab[RSIG][k0];
      else ttv += -(fse * c.tab[RSIG1][k0]);
    }
  }
  if (k == KX - 1) {
    ttv += at(L::SHF + 2, col) * rps * c.tab[GRDSCP][KX - 1];
    qtv += at(L::EVAP + 2, col) * rps * c.tab[GRDSIG][KX - 1];
  }
  at(L::TTEND + k, col) = ttend + ttv;
  at(L::QTEND + k, col) = qtend + qtv;
  at(L::UTEND + k, col) =
      k == KX - 1 ? at(L::USTR + 2, col) * rps * c.tab[GRDSIG][KX - 1] : T(0.0);
  at(L::VTEND + k, col) =
      k == KX - 1 ? at(L::VSTR + 2, col) * rps * c.tab[GRDSIG][KX - 1] : T(0.0);
}

// ---- walker phases: one lane per column ----

// Convection (convection.py), condensation's sum and top, and (SW steps)
// clouds (shortwave.py clouds). Leaves dfse/dfqa in the ttend/qtend rows.
// The level loops are unrolled, so the compiler issues a walker's
// shared-memory loads ahead of the chain that needs them (rolled, the
// chain waits on each load: 2x slower at T30).
template <typename T, int KX, bool SW>
__device__ __forceinline__ void walk_convection(const ColumnTables<T>& c,
                                                Tile<T> at, int col) {
  using L = Layout<KX, SW>;
  constexpr int nl1 = KX - 1;  // 1-based next-to-lowest level
  T se[KX], qg[KX], qsat[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    se[k] = at(L::SE + k, col);
    qg[k] = at(L::QG + k, col);
    qsat[k] = at(L::QSAT + k, col);
  }
  const T psg = exp(at(L::SFC, col));

  int itop;
  T qdif;
  {
    const T mse0 = se[KX - 1] + T(ALHC) * qg[KX - 1];
    const T mse1 = mn(mse0, se[nl1 - 1] + T(ALHC) * qg[nl1 - 1]);
    const T mss0 = mx(mse0, se[KX - 1] + T(ALHC) * qsat[KX - 1]);
    int ktop1 = KX, ktop2 = KX;
    T msthr = T(0.0);
#pragma unroll
    for (int k = 3; k < KX - 2; ++k) {  // 1-based candidate levels
      const int k0 = k - 1;
      const T m0 = se[k0] + T(ALHC) * qsat[k0];
      const T m1 = se[k0 + 1] + T(ALHC) * qsat[k0 + 1];
      const T mss2 = m0 + c.tab[WVI2][k0] * (m1 - m0);
      if (mss0 > mss2 && ktop1 > k) ktop1 = k;
      if (mse1 > mss2 && ktop2 > k) { ktop2 = k; msthr = mss2; }
    }
    const T qthr0 = T(RHBL) * qsat[KX - 1];
    const T qthr1 = T(RHBL) * qsat[nl1 - 1];
    const bool lqthr = qg[KX - 1] > qthr0 && qg[nl1 - 1] > qthr1;
    const bool base_ok = psg > T(PSMIN) && ktop1 < KX;
    const bool deep = base_ok && ktop2 < KX;
    const bool shallow = base_ok && ktop2 >= KX && lqthr;
    itop = (deep || shallow) ? ktop1 : KX + 1;
    qdif = deep ? mx(qg[KX - 1] - qthr0, (mse0 - msthr) / T(ALHC))
                : (shallow ? qg[KX - 1] - qthr0 : T(0.0));
  }
  T dfse[KX], dfqa[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) dfse[k] = dfqa[k] = T(0.0);
  T cbmf = T(0.0), precnv = T(0.0);
  if (itop <= KX) {
    const T rdps = T(2.0 / (1.0 - PSMIN));
    const T qmax = mx(T(1.01) * qg[KX - 1], qsat[KX - 1]);
    const T w = c.tab[WVI2][nl1 - 1];
    const T sb = se[nl1 - 1] + w * (se[KX - 1] - se[nl1 - 1]);
    T qb = qg[nl1 - 1] + w * (qg[KX - 1] - qg[nl1 - 1]);
    qb = mn(qb, qg[KX - 1]);
    const T fpsa = psg * mn((psg - T(PSMIN)) * rdps, T(1.0));
    cbmf = c.fm0 * fpsa * mn(qdif / mx(qmax - qb, T(1e-30)), T(FQMAX));
    T fmass = cbmf, fus = cbmf * se[KX - 1], fuq = cbmf * qmax,
      fds = cbmf * sb, fdq = cbmf * qb;
    dfse[KX - 1] = fds - fus;
    dfqa[KX - 1] = fdq - fuq;
#pragma unroll
    for (int k = KX - 1; k >= 2; --k) {  // 1-based, downward
      const int k0 = k - 1;
      const bool mid = k >= itop + 1;
      if (mid) {
        dfse[k0] += fus - fds;
        dfqa[k0] += fuq - fdq;
        const T enmass = c.tab[ENTR][k - 2] * psg * cbmf;
        const T fmass_n = fmass + enmass;
        const T fus_n = fus + enmass * se[k0];
        const T fuq_n = fuq + enmass * qg[k0];
        const T wk = c.tab[WVI2][k0 - 1];
        const T sb_k = se[k0 - 1] + wk * (se[k0] - se[k0 - 1]);
        const T qb_k = qg[k0 - 1] + wk * (qg[k0] - qg[k0 - 1]);
        const T fds_n = fmass_n * sb_k;
        const T fdq_n = fmass_n * qb_k;
        dfse[k0] += fds_n - fus_n;
        dfqa[k0] += fdq_n - fuq_n;
        const T delq = T(RHIL) * qsat[k0] - qg[k0];
        if (delq > T(0.0)) {
          const T fsq = T(SMF) * cbmf * delq;
          dfqa[k0] += fsq;
          dfqa[KX - 1] += -fsq;
        }
        fmass = fmass_n; fus = fus_n; fuq = fuq_n; fds = fds_n; fdq = fdq_n;
      } else if (k == itop) {
        const T qsatb = qsat[k0] + c.tab[WVI2][k0] * (qsat[k0 + 1] - qsat[k0]);
        const T prec_k = mx(fuq - fmass * qsatb, T(0.0));
        precnv = prec_k;
        dfse[k0] += fus - fds + T(ALHC) * prec_k;
        dfqa[k0] += fuq - fdq - prec_k;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    at(L::TTEND + k, col) = dfse[k];
    at(L::QTEND + k, col) = dfqa[k];
  }
  at(L::ICNV, col) = T(KX - itop);

  // large-scale condensation: the precipitation and the cloud top
  T precls;
  {
    T acc = T(0.0);
    int ktop = KX + 1;
#pragma unroll
    for (int k = 1; k < KX; ++k) {  // level 1 excluded
      const T dqa = c.tab[RHREF][k] * qsat[k] - qg[k];
      if (dqa < T(0.0)) {
        const T dq = dqa * T(RTLSC);
        acc += c.tab[LSCP][k - 1] * dq;
        if (ktop > k + 1) ktop = k + 1;
      }
    }
    itop = mn(ktop, itop);
    precls = -acc * psg;
  }
  at(L::PRECNV, col) = precnv;
  at(L::PRECLS, col) = precls;
  at(L::CBMF, col) = cbmf;

  if constexpr (SW) {
    T rh[KX];
#pragma unroll
    for (int k = 0; k < KX; ++k) rh[k] = at(L::RH + k, col);
    const T gse = (se[KX - 2] - se[KX - 1]) /
                  (at(L::PHI + KX - 2, col) - at(L::PHI + KX - 1, col));
    const bool above = rh[nl1 - 1] > T(RHCL1);
    T cloudc = above ? rh[nl1 - 1] - T(RHCL1) : T(0.0);
    int icltop = above ? nl1 : KX + 1;
#pragma unroll
    for (int k = 3; k < KX - 1; ++k) {
      const int k0 = k - 1;
      const T drh = rh[k0] - T(RHCL1);
      if (drh > cloudc && qg[k0] > T(QACL)) { cloudc = drh; icltop = k; }
    }
    const T pr1 = mn(T(86.4) * (precnv + precls), T(PMAXCL));
    const T cc = mn(cloudc * T(1.0 / (RHCL2 - RHCL1)), T(1.0));
    cloudc = mn(T(WPCL) * sqrt(pr1) + cc * cc, T(1.0));
    icltop = itop < icltop ? itop : icltop;
    const T fstab =
        mn(mx(T(1.0 / (GSE_S1 - GSE_S0)) * (gse - T(GSE_S0)), T(0.0)), T(1.0));
    T clstr = fstab * mx(T(CLSMAX) - T(1.2) * cloudc, T(0.0));
    const T clstrl = mx(clstr, T(CLSMINL)) * rh[KX - 1];
    clstr = clstr + at(L::SFC + 10, col) * (clstrl - clstr);
    at(L::CLOUDC, col) = cloudc;
    at(L::ICLTOP, col) = T(icltop);
    at(L::CLSTR, col) = clstr;
  }
}

// The SW down and up passes (shortwave_rad_fluxes) from the levels'
// tau_1, tau_2 and refl; writes tt_rsw, ssrd, ssr, tsr and stratc.
template <typename T, int KX>
__device__ __forceinline__ void walk_shortwave(const ColumnTables<T>& c,
                                               Tile<T> at, int col) {
  using L = Layout<KX, true>;
  const T psg = exp(at(L::SFC, col));
  const T rps = T(1.0) / psg;
  const T fsol = at(L::LAT, col), ozupp = at(L::LAT + 1, col),
          ozone = at(L::LAT + 2, col);
  T tau_1[KX], tau_2[KX], refl[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    tau_1[k] = at(L::TAU1 + k, col);
    tau_2[k] = at(L::TAU2S + k, col);
    refl[k] = at(L::REFL + k, col);
  }
  // downward pass
  T dfabs[KX], refl_flux[KX];
  T flux1 = fsol * T(1.0 - 0.05);
  T flux2 = fsol * T(0.05);
  T d = flux1;
  flux1 = tau_1[0] * (flux1 - ozupp * psg);
  dfabs[0] = d - flux1;
  d = flux1;
  flux1 = tau_1[1] * (flux1 - ozone * psg);
  dfabs[1] = d - flux1;
  refl_flux[0] = refl_flux[1] = T(0.0);
#pragma unroll
  for (int k0 = 2; k0 < KX; ++k0) {
    const T rk = flux1 * refl[k0];
    refl_flux[k0] = rk;
    flux1 = flux1 - rk;
    d = flux1;
    flux1 = tau_1[k0] * flux1;
    dfabs[k0] = d - flux1;
  }
#pragma unroll
  for (int k0 = 1; k0 < KX; ++k0) {
    dfabs[k0] = dfabs[k0] + flux2;
    flux2 = tau_2[k0] * flux2;
    dfabs[k0] = dfabs[k0] - flux2;
  }
  // surface and upward pass
  const T ssrd = flux1 + flux2;
  flux1 = flux1 * at(L::SFC + 1, col);
  const T ssr = ssrd - flux1;
#pragma unroll
  for (int k0 = KX - 1; k0 >= 0; --k0) {
    dfabs[k0] = dfabs[k0] + flux1;
    flux1 = tau_1[k0] * flux1;
    dfabs[k0] = dfabs[k0] - flux1;
    flux1 = flux1 + refl_flux[k0];
  }
#pragma unroll
  for (int k = 0; k < KX; ++k)
    at(L::TTRSW + k, col) = dfabs[k] * rps * c.tab[GRDSCP][k];
  at(L::SSRD, col) = ssrd;
  at(L::SSR, col) = ssr;
  at(L::TSR, col) = fsol - flux1;
  at(L::STRATC, col) = at(L::LAT + 4, col) * psg;
  at(L::STRATC + 1, col) = c.eps1 * psg;
}

// LW down (longwave.py downward_longwave_vec, or with REFLW
// downward_longwave): writes the levels' dfabs into the LW rows, slrd, and
// the four band fluxes at the surface.
template <typename T, int KX, bool SW, bool REFLW>
__device__ __forceinline__ void walk_lw_down(Tile<T> at, int col) {
  using L = Layout<KX, SW>;
  auto tau = [&](int b, int k) { return at(L::TAU2_LW + b * KX + k, col); };
  auto fb = [&](int b, int k) { return at(L::FB + b * KX + k, col); };
  T flux[4];
  {
    const T s1 = at(L::ST4A1, col), s2 = at(L::ST4A2, col);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T emis = T(1.0) - tau(b, 0);
      flux[b] = emis * (fb(b, 0) * (s1 + emis * s2));
    }
  }
  flux[2] = flux[3] = T(0.0);
  if constexpr (REFLW) at(L::LW, col) = (-flux[0]) - flux[1];
  else at(L::LW, col) = -(flux[0] + flux[1]);
  T dfa_last = T(0.0);
#pragma unroll
  for (int k = 1; k < KX; ++k) {
    const T s1 = at(L::ST4A1 + k, col), s2 = at(L::ST4A2 + k, col);
    // the reference's order: 0, then +f and -f_new band after band
    T acc = T(0.0);
    const T dfa = band_sum(flux);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const T emis = T(1.0) - tau(b, k);
      const T brad = fb(b, k) * (s1 + emis * s2);
      if constexpr (REFLW) acc = acc + flux[b];
      flux[b] = tau(b, k) * flux[b] + emis * brad;
      if constexpr (REFLW) acc = acc - flux[b];
    }
    if constexpr (REFLW) {
      if (k < KX - 1) at(L::LW + k, col) = acc;
      else dfa_last = acc;
    } else {
      if (k < KX - 1) at(L::LW + k, col) = dfa - band_sum(flux);
      else dfa_last = dfa - band_sum(flux);
    }
  }
  T slrd = T(EMISFC) * band_sum(flux);
  const T corlw = T(EPSLW * EMISFC) * at(L::ST4A1 + KX - 1, col);
  at(L::LW + KX - 1, col) = dfa_last - corlw;
  slrd = slrd + corlw;
  at(L::SLRD, col) = slrd;
#pragma unroll
  for (int b = 0; b < 4; ++b) at(L::FLUX + b, col) = flux[b];
}

// Surface fluxes and land skin temperature (surface.py), then LW up
// (longwave.py upward_longwave_vec, or with REFLW upward_longwave); turns
// the LW rows into each level's LW heating rate.
template <typename T, int KX, bool SW, bool REFLW>
__device__ __forceinline__ void walk_surface_lw_up(const ColumnTables<T>& c,
                                                   Tile<T> at, int col) {
  using L = Layout<KX, SW>;
  constexpr int nl1 = KX - 1;
  const T psg = exp(at(L::SFC, col));
  const T rps = T(1.0) / psg;
  const T ua = at(L::UA, col), va = at(L::VA, col);
  const T tg_s = at(L::TG + KX - 1, col), tg_n = at(L::TG + nl1 - 1, col);
  const T qg_s = at(L::QG + KX - 1, col);
  const T alb_l = at(L::SFC + 2, col), alb_s = at(L::SFC + 3, col),
          snowc = at(L::SFC + 4, col), soilw_am = at(L::SFC + 5, col),
          stl_am = at(L::SFC + 6, col), sst_am = at(L::SFC + 7, col),
          forog = at(L::SFC + 8, col), phis0 = at(L::SFC + 9, col),
          fmask_l = at(L::SFC + 10, col);
  const T coa = at(L::LAT + 5, col);
  const T ssrd = at(SW ? L::SSRD : L::SSRD_IN, col);
  const T slrd = at(L::SLRD, col);

  const T esbc = T(EMISFC * SBC);
  const T u0 = T(FWIND0) * ua, v0 = T(FWIND0) * va;
  const T dt1 = c.tab[WVI2][KX - 1] * (tg_s - tg_n);
  T t1_l = tg_s + dt1;
  T t1_s = t1_l - phis0 * dt1 / c.t1s_den;
  const T t2_s = tg_s + at(L::PHI + KX - 1, col) / T(CP);
  const T t2_l = t2_s - phis0 / T(CP);
  if (tg_s > tg_n) {
    t1_l = T(FTEMP0) * t1_l + T(1.0 - FTEMP0) * t2_l;
    t1_s = T(FTEMP0) * t1_s + T(1.0 - FTEMP0) * t2_s;
  } else {
    t1_l = tg_s;
    t1_s = tg_s;
  }
  const T t0 = t1_s + fmask_l * (t1_l - t1_s);
  const T denvvs0 = (T(P0) * psg / (T(RGAS) * t0)) *
                    sqrt(u0 * u0 + v0 * v0 + T(VGUST * VGUST));

  T tskin = stl_am + T(CTDAY) * sqrt(coa) * ssrd * (T(1.0) - alb_l) * psg;
  const T rdth = T(FSTAB / DTHETA);
  const T dthl = tskin > t2_l ? mn(tskin - t2_l, T(DTHETA))
                              : mx(T(0.5) * (tskin - t2_l), T(-DTHETA));
  const T denvvs1 = denvvs0 * (T(1.0) + dthl * rdth);
  const T cdldv = T(CDL) * denvvs0 * forog;
  const T ustr_l = -cdldv * ua, vstr_l = -cdldv * va;
  const T chlcp = T(CHL * CP);
  T shf_l = chlcp * denvvs1 * (tskin - t1_l);
  const T qsat_skin = qsat_of(tskin, psg);
  T evap_l = T(CHL) * denvvs1 * mx(soilw_am * qsat_skin - qg_s, T(0.0));

  const T tsk3 = tskin * tskin * tskin;
  const T dslr = T(4.0 * (EMISFC * SBC)) * tsk3;
  T slru_l = esbc * tsk3 * tskin;
  T hfluxn_l = ssrd * (T(1.0) - alb_l) + slrd - (slru_l + shf_l + T(ALHC) * evap_l);
  const T clamb = T(CLAMBDA) + snowc * T(CLAMBSN - CLAMBDA);
  hfluxn_l = hfluxn_l - clamb * (tskin - stl_am);
  const T qsat_skin1 = qsat_of(tskin + T(1.0), psg);
  const T dqsat = evap_l > T(0.0) ? soilw_am * (qsat_skin1 - qsat_skin) : T(0.0);
  const T dtskin =
      hfluxn_l / (clamb + dslr + T(CHL) * denvvs1 * (T(CP) + T(ALHC) * dqsat));
  tskin = tskin + dtskin;
  shf_l = shf_l + chlcp * denvvs1 * dtskin;
  evap_l = evap_l + T(CHL) * denvvs1 * dqsat * dtskin;
  slru_l = slru_l + dslr * dtskin;
  hfluxn_l = clamb * (tskin - stl_am);

  const T tsea = sst_am;
  const T dths = tsea > t2_s ? mn(tsea - t2_s, T(DTHETA))
                             : mx(T(0.5) * (tsea - t2_s), T(-DTHETA));
  const T denvvs2 = denvvs0 * (T(1.0) + dths * rdth);
  const T cdsdv = T(CDS) * denvvs2;
  const T ustr_s = -cdsdv * ua, vstr_s = -cdsdv * va;
  const T shf_s = T(CHS * CP) * denvvs2 * (tsea - t1_s);
  const T evap_s = T(CHS) * denvvs2 * (qsat_of(tsea, psg) - qg_s);
  const T tsea2 = tsea * tsea;
  const T slru_s = esbc * (tsea2 * tsea2);
  const T hfluxn_s = ssrd * (T(1.0) - alb_s) + slrd - slru_s + shf_s + T(ALHC) * evap_s;
  auto blend = [&](T a_l, T a_s) { return a_s + fmask_l * (a_l - a_s); };
  const T slru_w = blend(slru_l, slru_s);
  const T tsfc = blend(stl_am, tsea);
  const T trios[5][3] = {{ustr_l, ustr_s, blend(ustr_l, ustr_s)},
                         {vstr_l, vstr_s, blend(vstr_l, vstr_s)},
                         {shf_l, shf_s, blend(shf_l, shf_s)},
                         {evap_l, evap_s, blend(evap_l, evap_s)},
                         {slru_l, slru_s, slru_w}};
#pragma unroll
  for (int f = 0; f < 5; ++f)
#pragma unroll
    for (int i = 0; i < 3; ++i) at(L::USTR + 3 * f + i, col) = trios[f][i];
  at(L::HFLUXN, col) = hfluxn_l;
  at(L::HFLUXN + 1, col) = hfluxn_s;
  at(L::TSFC, col) = tsfc;
  at(L::TSKIN, col) = blend(tskin, tsea);
  at(L::U0, col) = u0;
  at(L::V0, col) = v0;
  at(L::T0, col) = t0;

  // LW up
  auto tau = [&](int b, int k) { return at(L::TAU2_LW + b * KX + k, col); };
  const T fsfcu = slru_w;
  at(L::SLR, col) = fsfcu - slrd;
  T fb[4], fl[4], dfa_add[KX];
  fband(tsfc, fb);
#pragma unroll
  for (int b = 0; b < 4; ++b)
    fl[b] = fb[b] * fsfcu + T(1.0 - EMISFC) * at(L::FLUX + b, col);
  // with REFLW, dfa_add[k] is the level's whole absorbed flux, carried on
  // from the LW down sweep's, and takes the reference's adds one by one
  if constexpr (REFLW) {
#pragma unroll
    for (int k = 0; k < KX; ++k) dfa_add[k] = at(L::LW + k, col);
    dfa_add[KX - 1] = dfa_add[KX - 1] + T(EPSLW) * fsfcu;
  } else {
#pragma unroll
    for (int k = 0; k < KX; ++k) dfa_add[k] = T(0.0);
    dfa_add[KX - 1] = T(EPSLW) * fsfcu;
  }
#pragma unroll
  for (int k = KX - 1; k >= 1; --k) {
    const T s1 = at(L::ST4A1 + k, col), s2 = at(L::ST4A2 + k, col);
    const T pre = band_sum(fl);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const T emis = T(1.0) - tau(b, k);
      const T brad = at(L::FB + b * KX + k, col) * (s1 - emis * s2);
      if constexpr (REFLW) dfa_add[k] = dfa_add[k] + fl[b];
      fl[b] = tau(b, k) * fl[b] + emis * brad;
      if constexpr (REFLW) dfa_add[k] = dfa_add[k] - fl[b];
    }
    if constexpr (!REFLW) dfa_add[k] = dfa_add[k] + pre - band_sum(fl);
  }
  {
    const T s1 = at(L::ST4A1, col), s2 = at(L::ST4A2, col);
    const T pre = fl[0] + fl[1];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T emis = T(1.0) - tau(b, 0);
      const T brad = at(L::FB + b * KX, col) * (s1 - emis * s2);
      if constexpr (REFLW) dfa_add[0] = dfa_add[0] + fl[b];
      fl[b] = tau(b, 0) * fl[b] + emis * brad;
      if constexpr (REFLW) dfa_add[0] = dfa_add[0] - fl[b];
    }
    if constexpr (!REFLW) dfa_add[0] = dfa_add[0] + pre - (fl[0] + fl[1]);
  }
  const T stratc0 = at(SW ? L::STRATC : L::STRATC_IN, col);
  const T stratc1 = at((SW ? L::STRATC : L::STRATC_IN) + 1, col);
  const T corlw1 = c.tab[DHS][0] * stratc1 * at(L::ST4A1, col) + stratc0;
  const T corlw2 = c.tab[DHS][1] * stratc1 * at(L::ST4A1 + 1, col);
  dfa_add[0] = dfa_add[0] - corlw1;
  dfa_add[1] = dfa_add[1] - corlw2;
  if constexpr (REFLW) {
    at(L::OLR, col) = corlw1 + corlw2 + fl[0] + fl[1] + fl[2] + fl[3];
#pragma unroll
    for (int k = 0; k < KX; ++k)
      at(L::LW + k, col) = dfa_add[k] * rps * c.tab[GRDSCP][k];
  } else {
    at(L::OLR, col) = corlw1 + corlw2 + band_sum(fl);
#pragma unroll
    for (int k = 0; k < KX; ++k)
      at(L::LW + k, col) =
          (at(L::LW + k, col) + dfa_add[k]) * rps * c.tab[GRDSCP][k];
  }
}

template <typename T, int KX, bool SW, bool MEMBERS, bool REFLW>
// fp64: at most 80 registers, so that three blocks share an SM (fp32
// fits four blocks without a cap)
__global__ void __launch_bounds__(kThreads, sizeof(T) == 8 ? 3 : 1)
column_physics_kernel(const __grid_constant__ ParamsOf<T, MEMBERS> p) {
  using L = Layout<KX, SW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile<T> at{reinterpret_cast<T*>(smem_raw)};
  const ColumnTables<T>& c = p.c;
  const int S = p.S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * kCols;
  // element offset of row r's member in an ensemble's launch
  auto in_member = [&](int r) -> size_t {
    if constexpr (MEMBERS)
      return static_cast<size_t>(blockIdx.y) * p.in_mstride[r];
    else
      return 0;
  };
  auto out_member = [&](int r) -> size_t {
    if constexpr (MEMBERS)
      return static_cast<size_t>(blockIdx.y) * p.out_mstride[r];
    else
      return 0;
  };

  // ---- stage the inputs: one warp per row of 32 neighbouring columns ----
  {
    // rows: the staged inputs, then the [il] fields and ablco2 gathered at
    // each column's latitude
    constexpr int NR = L::N_IN_ROWS + N_LAT;
    constexpr int PER = (NR + 7) / 8;
    const int g = min(col0 + lane, S - 1);
    const int gj = g / p.ix;
    T v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = warp + 8 * i;
      if (r < L::N_IN_ROWS) {
        v[i] = (static_cast<const T*>(p.in_rows[r]) + in_member(r))[g];
      } else if (r < NR) {
        const int f = r - L::N_IN_ROWS;
        v[i] = p.lat[f][f < N_LAT - 1 ? gj : 0];
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = warp + 8 * i;
      if (r < L::N_IN_ROWS) at(r, lane) = v[i];
      else if (r < NR) at(L::LAT + r - L::N_IN_ROWS, lane) = v[i];
    }
    // the level tables: a lane reads its level's entries from shared
    // memory, where the parameter bank would serialise a warp's distinct
    // addresses
    if (tid < N_TABLES * MAXL)
      at(L::TAB + tid / MAXL, tid % MAXL) = (&c.tab[0][0])[tid];
  }
  __syncthreads();

  // a level lane: column lc of the block, level k
  const int lc = tid >> 3, k = tid & 7;
  const bool lev = k < KX;
  // a walker (warps 0 and 1): column lane of the block

  T psg = T(1.0), lsc_q = T(0.0), lsc_t = T(0.0);
  bool lsc = false;
  if (lev) {
    psg = exp(at(L::SFC, lc));
    lsc = level_humidity<T, KX, SW>(c, at, lc, k, psg, lsc_q, lsc_t);
  }
  __syncthreads();

  // convection beside (non-SW steps) LW down, which needs nothing of it
  if (warp == 0) walk_convection<T, KX, SW>(c, at, lane);
  if (!SW && warp == 1) walk_lw_down<T, KX, SW, REFLW>(at, lane);
  __syncthreads();

  if constexpr (SW) {
    if (lev) level_transmissivities<T, KX>(c, at, lc, k, psg);
    __syncthreads();
    if (warp == 0) walk_shortwave<T, KX>(c, at, lane);
    if (warp == 1) walk_lw_down<T, KX, SW, REFLW>(at, lane);
    __syncthreads();
  }

  if (warp == 0) walk_surface_lw_up<T, KX, SW, REFLW>(c, at, lane);
  __syncthreads();

  if (lev)
    level_tendencies<T, KX, SW>(c, at, lc, k, T(1.0) / psg, lsc, lsc_q,
                                lsc_t);
  __syncthreads();

  // ---- store the outputs, one warp per row ----
  if (col0 + lane < S) {
#pragma unroll
    for (int i = 0; i < (L::N_OUT_ROWS + 7) / 8; ++i) {
      const int r = warp + 8 * i;
      if (r < L::N_OUT_ROWS)
        (static_cast<T*>(p.out_rows[r]) + out_member(r))[col0 + lane] =
            at(L::OUT + r, lane);
    }
  }
}

// Rows of each input (fused.kernel_inputs order; the [il] fields and
// ablco2 are read in place, not staged) and output (fused.output_shapes).
template <int KX>
constexpr int input_rows(int i) {
  return (i >= 2 && i <= 4) ? KX : (i <= 15) ? 1 : (i <= 22) ? 0
       : i == 23 ? 4 * KX : i == 24 ? 2 : i == 25 ? KX : 1;
}
template <int KX>
constexpr int output_rows(int i) {
  return i <= 3 ? KX : i <= 9 ? 1 : i <= 14 ? 3 : i == 15 ? 2 : i <= 20 ? 1
       : i == 21 ? 4 * KX : i == 22 ? 2 : i == 23 ? KX : 1;
}

template <typename T, int KX, bool SW, bool MEMBERS, bool REFLW>
cudaError_t launch(int members, const void* const* ins,
                   const long long* in_mstride, void* const* outs,
                   const double* block, int il, int ix, cudaStream_t stream) {
  using L = Layout<KX, SW>;
  ParamsOf<T, MEMBERS> p;
  const long long S1 = static_cast<long long>(il) * ix;
  if (members < 1 || members > 65535 || S1 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t row = static_cast<size_t>(S1) * sizeof(T);
  int n = 0;
  for (int i = 0; i < (SW ? N_IN_SW : N_IN); ++i) {
    if (in_mstride[i] < 0 || in_mstride[i] > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    for (int r = 0; r < input_rows<KX>(i); ++r) {
      if constexpr (MEMBERS) p.in_mstride[n] = static_cast<int>(in_mstride[i]);
      p.in_rows[n++] = static_cast<const char*>(ins[i]) + r * row;
    }
  }
  if (n != L::N_IN_ROWS) return cudaErrorInvalidValue;
  n = 0;
  for (int i = 0; i < (SW ? N_OUT : N_OUT_NOSW); ++i)
    for (int r = 0; r < output_rows<KX>(i); ++r) {
      // outputs are [M, rows, il, ix], contiguous
      if constexpr (MEMBERS)
        p.out_mstride[n] = static_cast<int>(output_rows<KX>(i) * S1);
      p.out_rows[n++] = static_cast<char*>(outs[i]) + r * row;
    }
  if (n != L::N_OUT_ROWS) return cudaErrorInvalidValue;
  for (int i = 0; i < N_LAT; ++i) p.lat[i] = static_cast<const T*>(ins[16 + i]);
  ColumnTables<T>& c = p.c;
  for (int t = 0; t < N_TABLES; ++t)
    for (int k = 0; k < MAXL; ++k) c.tab[t][k] = T(block[t * MAXL + k]);
  const double* s = block + N_TABLES * MAXL;
  c.fm0 = T(s[0]);
  c.t1s_den = T(s[1]);
  c.eps1 = T(s[2]);
  c.fshcq = T(s[3]);
  c.fshcse = T(s[4]);
  c.fvdise = T(s[5]);
  c.vdif_mask = static_cast<int>(s[6]);
  p.S = static_cast<int>(S1);
  p.ix = ix;

  constexpr int smem = smem_bytes<T, KX, SW>();
  static_assert(smem <= kMaxSmem, "a block's rows exceed shared memory");
  if (smem > kStaticSmem) {
    // opt in once per device
    static unsigned opted_in = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 32) return cudaErrorInvalidDevice;
    if (!((opted_in >> dev) & 1u)) {
      err = cudaFuncSetAttribute(column_physics_kernel<T, KX, SW, MEMBERS, REFLW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      opted_in |= 1u << dev;
    }
  }
  const dim3 blocks((p.S + kCols - 1) / kCols, members);
  column_physics_kernel<T, KX, SW, MEMBERS, REFLW>
      <<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int KX, bool REFLW>
cudaError_t launch_sw(int sw, int members, const void* const* ins,
                      const long long* ms, void* const* outs,
                      const double* block, int il, int ix, cudaStream_t st) {
  // one model (or one member) takes the kernel without member strides
  if (members > 1)
    return sw ? launch<T, KX, true, true, REFLW>(members, ins, ms, outs,
                                                 block, il, ix, st)
              : launch<T, KX, false, true, REFLW>(members, ins, ms, outs,
                                                  block, il, ix, st);
  return sw ? launch<T, KX, true, false, REFLW>(members, ins, ms, outs, block,
                                                il, ix, st)
            : launch<T, KX, false, false, REFLW>(members, ins, ms, outs,
                                                 block, il, ix, st);
}

template <typename T, int KX>
cudaError_t launch_order(int reflw, int sw, int members,
                         const void* const* ins, const long long* ms,
                         void* const* outs, const double* block, int il,
                         int ix, cudaStream_t st) {
  return reflw ? launch_sw<T, KX, true>(sw, members, ins, ms, outs, block, il,
                                        ix, st)
               : launch_sw<T, KX, false>(sw, members, ins, ms, outs, block,
                                         il, ix, st);
}

template <typename T>
cudaError_t launch_kx(int kx, int reflw, int sw, int members,
                      const void* const* ins, const long long* ms,
                      void* const* outs, const double* block, int il, int ix,
                      cudaStream_t st) {
  switch (kx) {
    case 5: return launch_order<T, 5>(reflw, sw, members, ins, ms, outs, block, il, ix, st);
    case 7: return launch_order<T, 7>(reflw, sw, members, ins, ms, outs, block, il, ix, st);
    case 8: return launch_order<T, 8>(reflw, sw, members, ins, ms, outs, block, il, ix, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int KX>
int layout_smem(int sw) {
  return sw ? smem_bytes<T, KX, true>() : smem_bytes<T, KX, false>();
}

}  // namespace

// C interface. members: the ensemble's member count (1 for one model);
// reflw: 1 for the reference-order LW sweeps (lw_band_vectorized=False),
// 0 for the band-vectorized ones; ins/outs: host arrays of 27 device pointers in the order of
// fused.kernel_inputs / fused.output_shapes (unused slots may be null),
// member 0's data; in_mstride: per input, the elements from one member's
// data to the next (0 where all members share it); outputs are
// [members, ...] and contiguous; block: the float64 argument block of
// fused.argument_block. Returns the cudaError_t of the launch (0 on
// success). Does not synchronise.
extern "C" int column_physics_launch(int f64, int kx, int sw, int members,
                                     int reflw, int il, int ix,
                                     const void* const* ins,
                                     const long long* in_mstride,
                                     void* const* outs, const double* block,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      f64 ? launch_kx<double>(kx, reflw, sw, members, ins, in_mstride, outs,
                              block, il, ix, st)
          : launch_kx<float>(kx, reflw, sw, members, ins, in_mstride, outs,
                             block, il, ix, st);
  return static_cast<int>(err);
}

// The launch for (type, kx, variant) on one model's il x ix grid: columns
// per block, threads, blocks and dynamic shared memory in bytes
// (fused.block_plan mirrors it; M members take M times the blocks).
// Returns 0, or cudaErrorInvalidValue for a kx that is not built.
extern "C" int column_physics_layout(int f64, int kx, int sw, int il, int ix,
                                     int* cols, int* threads, int* blocks,
                                     int* smem) {
  *cols = kCols;
  *threads = kThreads;
  *blocks = (il * ix + kCols - 1) / kCols;
  switch (kx) {
    case 5: *smem = f64 ? layout_smem<double, 5>(sw) : layout_smem<float, 5>(sw); break;
    case 7: *smem = f64 ? layout_smem<double, 7>(sw) : layout_smem<float, 7>(sw); break;
    case 8: *smem = f64 ? layout_smem<double, 8>(sw) : layout_smem<float, 8>(sw); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}
